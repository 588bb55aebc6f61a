"""Time the mesh step on one launcher and on two, in turns, on the card.

    python -m gasfm_tpu_torch.tools.mesh_launchers [--rounds 2] [--steps 6]

The flagship (``tools/profile_forward.py`` ``FLAGSHIP``, weights from seed
0) trains on the dense bench scene, table-sharded under ``[1, 2]``, from
fresh ranks each run: one launcher meeting on a file store
(``parallel.run_ranks``), one launcher on the coordinator's TCP store
(``parallel.Distributed`` with ``num_processes = 1``), and two launcher
processes meeting at 127.0.0.1 and a free port (``num_processes = 2``),
in turns, ``--rounds`` times. Each run prints rank 0's ms per
``fused_group_step`` (host clock, the card synchronised around each), the
gradient all-reduce alone after them, and a digest of the weights, which
every run must share; then one JSON line of all runs. The ranks share the
card over gloo; a machine without one fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

KINDS = ("one launcher", "one launcher, TCP store", "two launchers")


def rank_steps(mesh, steps: int) -> dict:
    """One rank's run: ``steps`` timed ``fused_group_step`` calls, then the
    gradient all-reduce alone, then the weights' digest."""
    from gasfm_tpu_torch.data.scene import SceneData
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.losses import FLAGSHIP_LOSS, ESFMLoss
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
    from gasfm_tpu_torch.tools.profile_forward import FLAGSHIP, SCENES
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.train.state import FLAGSHIP_OPTIM

    dev = mesh.device
    model = GraphAttnSfMNet(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    session = TrainingSession(model, ESFMLoss(**FLAGSHIP_LOSS), device=dev, optim=FLAGSHIP_OPTIM,
                              capture=False, mesh=mesh)
    d = generate_synthetic_scene(**SCENES["dense"])
    graph = session.scene_graph(SceneData(d.M, d.Ns, d.y, "dense", calibrated=True))

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0)

    ms = [timed(lambda: session.fused_group_step([graph])) for _ in range(steps)]
    _, _, grads = session.group_loss_and_grads([graph])
    bufs = [g.clone() for g in grads]
    allreduce_ms = timed(lambda: mesh.sum_over_world(bufs))
    flat = torch.cat([p.detach().reshape(-1) for p in session.params]).cpu()
    return dict(ms=ms, allreduce_ms=allreduce_ms,
                digest=hashlib.sha256(flat.numpy().tobytes()).hexdigest())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(n_processes: int, steps: int, tmp: str) -> list:
    """``n_processes`` launcher processes of this tool, meeting at
    127.0.0.1: rank 0's result."""
    from gasfm_tpu_torch.parallel import Distributed

    port = _free_port()
    procs, paths = [], []
    for pid in range(n_processes):
        path = os.path.join(tmp, f"launcher{pid}.pt")
        torch.save((steps, Distributed("127.0.0.1", port, n_processes, pid)), path)
        paths.append(path)
        procs.append(subprocess.Popen([sys.executable, "-m", "gasfm_tpu_torch.tools.mesh_launchers",
                                       "--launcher", path]))
    rcs = [p.wait() for p in procs]
    if rcs != [0] * n_processes:
        raise RuntimeError(f"the launchers exited {rcs}")
    return torch.load(paths[0] + ".out", weights_only=False)


def main(argv=None) -> int:
    from gasfm_tpu_torch.ops.kernels import build
    from gasfm_tpu_torch.parallel import run_ranks
    from gasfm_tpu_torch.tools import mesh_launchers

    p = argparse.ArgumentParser(prog="python -m gasfm_tpu_torch.tools.mesh_launchers")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--launcher", help=argparse.SUPPRESS)  # one launcher process of a run
    args = p.parse_args(argv)
    if args.launcher:
        steps, spec = torch.load(args.launcher, weights_only=False)
        res = run_ranks(mesh_launchers.rank_steps, 1, 2, args=(steps,), device="cuda",
                        distributed=spec)
        torch.save(res[0] if spec.process_id == 0 else None, args.launcher + ".out")
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("mesh_launchers: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    build.build_all()
    runs = []
    with tempfile.TemporaryDirectory(prefix="gasfm_launchers_") as tmp:
        for k in range(args.rounds * len(KINDS)):
            kind = KINDS[k % len(KINDS)]
            t0 = time.perf_counter()
            if kind == KINDS[0]:
                r0 = run_ranks(mesh_launchers.rank_steps, 1, 2, args=(args.steps,),
                               device="cuda")[0]
            else:
                r0 = _launch(1 if kind == KINDS[1] else 2, args.steps, tmp)
            r0.update(kind=kind, wall_s=time.perf_counter() - t0)
            runs.append(r0)
            print(f"{kind}: ms per step {[round(t, 1) for t in r0['ms']]}, the gradient "
                  f"all-reduce alone {r0['allreduce_ms']:.1f} ms, wall {r0['wall_s']:.1f} s, "
                  f"weights {r0['digest'][:12]}", flush=True)
    if len({r["digest"] for r in runs}) != 1:
        raise SystemExit("mesh_launchers: the runs' weights differ")
    print(json.dumps(dict(device=smi, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
