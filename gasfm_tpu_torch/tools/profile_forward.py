"""Where a forward request's, or a training step's, time goes on the card.

    python -m gasfm_tpu_torch.tools.profile_forward
        [--model gasfm|dpesfm|gasfm-depth|dpesfm-depth]
        [--scene dense|powerlaw|wide] [--requests 3] [--train | --capture]

Builds the flagship GraphAttnSfMNet (9 layers, 4 heads, widths
32/64/1024/2048, seeded init) or, with ``--model dpesfm``, the DPESFM
SetOfSetNet (one block of 3 layers, 256 wide, seeded init); the ``-depth``
models are the same with the conf's depth head (128 wide, 2 hidden layers)
in place of the view and scenepoint heads, and ``DirectDepthLoss`` (L1) on
the scene's triangulated GT depths. Then one of the synthetic scenes (the
two bench scenes, on which GASFM takes its merged path, or ``wide``, 1280
views, on which it takes the unfused one), two warm-up requests, then
``--requests`` requests traced with ``torch.profiler``: forward + loss
through ``TrainingSession``, or with ``--train`` one training step each
(``TrainingSession.fused_step``; for a depth model ``loss_and_grads`` +
``update``, the JAX package's loop for it), with the model's conf's loss and
optimizer: eagerly with ``--train`` (``capture=False``, one launch per
operation), or with ``--capture`` replays of the step recorded as CUDA
graphs (the session's default on the card; the two warm-up steps are the
recording's eager warm-up and the recording). Prints the wall time per
request, the device time per kernel name (the port's own kernels, each with
its launches and time per launch, then the top 15 of all), the hand-written
kernels' share, the optimizer's kernels (Adam's and the multi-tensor
kernels other than the gradient norm's), the number of kernel launches per
request, and the device busy share: summed kernel time over wall time (one
stream, so kernels never overlap). Writes the Chrome trace to
``chiprun_out/profile_<model>_{forward,train,capture}_<scene>.json``.
"""

from __future__ import annotations

import argparse
import collections
import time
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.losses import (
    DEPTH_LOSS,
    DPESFM_LOSS,
    FLAGSHIP_LOSS,
    DirectDepthLoss,
    ESFMLoss,
)
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
from gasfm_tpu_torch.train.loop import TrainingSession
from gasfm_tpu_torch.train.state import DPESFM_OPTIM, FLAGSHIP_OPTIM
from gasfm_tpu_torch.utils.device import resolve_device

# The flagship GASFM (confs/gasfm/optim_euc_gasfm.conf) and the synthetic
# scenes: the two bench scenes of the JAX package's bench.py, dense (~116k
# edges, 14 edges per point) and power-law track lengths (~70k edges, 3 edges
# per point); and "wide", power-law tracks over 1280 views, more cameras than
# the 1024 of the merged path (a 1DSfM-scale collection's camera count).
FLAGSHIP = dict(num_layers=9, n_heads=4, n_feat_proj=32, n_feat_scenepoint=64,
                n_feat_view=1024, n_feat_global=2048, stateful_global_features=True,
                add_skipconn_from_init_projfeat=True)
# The DPESFM baseline of confs/dpesfm/learning_euc_noaug_dpesfm.conf (:44-66):
# one block of three set-of-sets layers, 256 wide, quat heads with 2 hidden layers.
DPESFM = dict(num_blocks=1, block_size=3, num_features=256, proj_feat_normalization=True,
              add_skipconn_for_residual_blocks=False, pos_emb_n_freq=0,
              rot_representation="quat", view_head_n_hidden_layers=2,
              scenepoint_head_n_hidden_layers=2)
# The conf's depth head (confs/gasfm/optim_euc_gasfm.conf:27-31, and the same
# block of the DPESFM conf, :52-56) switched on, the view and scenepoint heads
# off (confs/synth/optim_synth_depth_gasfm.conf:38-40): DirectDepthLoss only.
DEPTH_HEAD = dict(depth_head_enabled=True, depth_head_n_feat=128, depth_head_n_hidden_layers=2,
                  view_head_enabled=False, scenepoint_head_enabled=False)
FLAGSHIP_DEPTH = dict(FLAGSHIP, **DEPTH_HEAD)
DPESFM_DEPTH = dict(DPESFM, **DEPTH_HEAD)
MODELS = ("gasfm", "dpesfm", "gasfm-depth", "dpesfm-depth")
SCENES = {
    "dense": dict(n_views=128, n_points=8192, visibility=0.2, seed=0),
    "powerlaw": dict(n_views=133, n_points=24576, track_length_dist="powerlaw", seed=0),
    "wide": dict(n_views=1280, n_points=16384, track_length_dist="powerlaw", seed=0),
}


def build_session(model_name: str, device, capture: Optional[bool] = None) -> TrainingSession:
    """A seeded model of ``model_name`` (one of ``MODELS``) with its conf's
    loss and optimizer; ``capture`` as ``TrainingSession`` takes it."""
    gen = torch.Generator().manual_seed(0)
    kw = dict(device=device, capture=capture)
    if model_name == "dpesfm":
        return TrainingSession(SetOfSetNet(**DPESFM, generator=gen), ESFMLoss(**DPESFM_LOSS),
                               optim=DPESFM_OPTIM, **kw)
    if model_name == "dpesfm-depth":
        return TrainingSession(SetOfSetNet(**DPESFM_DEPTH, generator=gen),
                               DirectDepthLoss(**DEPTH_LOSS), optim=DPESFM_OPTIM, **kw)
    if model_name == "gasfm-depth":
        return TrainingSession(GraphAttnSfMNet(**FLAGSHIP_DEPTH, generator=gen),
                               DirectDepthLoss(**DEPTH_LOSS), optim=FLAGSHIP_OPTIM, **kw)
    return TrainingSession(GraphAttnSfMNet(**FLAGSHIP, generator=gen),
                           ESFMLoss(**FLAGSHIP_LOSS), optim=FLAGSHIP_OPTIM, **kw)


def optimizer_kernel(name: str) -> bool:
    """Whether a kernel is the optimizer's: fused Adam's, or a multi-tensor
    kernel other than the gradient norm's (multi-tensor Adam's)."""
    return "adam" in name.lower() or ("multi_tensor_apply" in name and "LpNorm" not in name)


def train_step(session: TrainingSession, scene) -> Tuple[torch.Tensor, ...]:
    """One training step as the JAX package's loop takes it: the fused step
    with our_repro, or for a depth model loss_and_grads + update. Returns
    (loss, our_repro, grad_norm), or (loss, grad_norm) for a depth model."""
    if session.model.depth_head_enabled:
        loss, _, grads = session.loss_and_grads(scene)
        return loss, session.update(grads)
    return session.fused_step(scene)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=MODELS, default="gasfm")
    ap.add_argument("--scene", choices=sorted(SCENES), default="dense")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--train", action="store_true", help="trace eager training steps")
    ap.add_argument("--capture", action="store_true",
                    help="trace replays of the training step recorded as CUDA graphs")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    train = args.train or args.capture
    session = build_session(args.model, dev, capture=args.capture)
    scene = generate_synthetic_scene(
        **SCENES[args.scene], store_depth_targets=session.model.depth_head_enabled
    ).to_scene_graph(device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def request():
        if train:
            train_step(session, scene)
        else:
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
        # user-annotation ranges (e.g. Optimizer.step) lie over the kernels
        # they enclose: counting them would count those kernels twice
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            k = kernels[evt.name]
            k[0] += 1
            k[1] += evt.time_range.elapsed_us()
    total = sum(t for _, t in kernels.values())
    ours = sum(t for name, (_, t) in kernels.items() if "gasfm::" in name)
    launches = sum(c for c, _ in kernels.values())
    R = args.requests
    g = scene.graph
    mode = "capture" if args.capture else "train" if train else "forward"
    print(f"{args.model}, scene {args.scene} ({mode}): {g.num_cams} views, {g.num_pts} points, "
          f"{g.num_edges} edges; device "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    print(f"wall {wall_us / R / 1e3:.3f} ms/request; device kernel time "
          f"{total / R / 1e3:.3f} ms/request; device busy share {total / wall_us:.4f}; "
          f"{launches / R:.1f} kernel launches/request; hand-written kernels "
          f"{ours / R / 1e3:.3f} ms/request ({ours / max(total, 1e-9):.4f} of device time)")
    opt = [(c, t) for name, (c, t) in kernels.items() if optimizer_kernel(name)]
    print(f"optimizer kernels: {sum(t for _, t in opt) / R / 1e3:.4f} ms/request, "
          f"{sum(c for c, _ in opt) / R:.1f} launches/request")
    print("the port's kernels:")
    for name, (count, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
        if "gasfm::" in name:
            print(f"  {t / R / 1e3:9.4f} ms/request  {count / R:6.1f} launches/request  "
                  f"{t / count / 1e3:.4f} ms/launch  {name[:100]}")
    print("all kernels, top 15:")
    for name, (count, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {t / R / 1e3:9.4f} ms/request  {count / R:6.1f} launches/request  {name[:110]}")
    out = Path(__file__).resolve().parents[2] / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / f"profile_{args.model}_{mode}_{args.scene}.json"))


if __name__ == "__main__":
    main()
