"""The port's bench: training-step throughput on one GPU, captured and eager.

    python -m gasfm_tpu_torch.tools.bench [--paths gasfm-dense,...]
        [--modes captured,eager] [--rounds 3] [--steps 128] [--eager-steps 20]

Counterpart of the JAX package's ``bench.py`` (``_measure_scene``,
``main``): the flagship GASFM's training step (9 layers, 4 heads, widths
32/64/1024/2048, seeded init; ``TrainingSession.fused_step``) on
``tools/profile_forward.py``'s scenes, and the step's edges per second,
valid edges x steps / seconds. Five paths (``PATHS``): GASFM on the dense,
power-law and wide scenes, DPESFM on the power-law scene, and the depth
flagship on the dense scene (``loss_and_grads`` + ``update``, the JAX
package's loop for a depth-only model). Each path runs twice from the same
weights in one process: captured (the step recorded as CUDA graphs, the
session's default on the card) and eager (``capture=False``, one launch per
operation from Python). Each takes two untimed steps (the captured one's
warm-up and recording), then ``--rounds`` rounds of back-to-back steps,
timed on the host clock between two ``torch.cuda.synchronize()``; a path's
ms per step is the median of its rounds.

Prints one JSON line: ``metric`` "gasfm_train_edges_per_s", ``value`` the
captured dense step's edges/s, ``powerlaw_edges_per_s``, and per path and
mode the ms per step (median and every round), edges/s, the port's kernel
launches per step (the launch counters over one eager step; captured, over
the recording: the kernels each replay runs), peak device memory (the
session's weights and optimizer state, its steps, and a captured one's
graph), and the
loss after the timed steps; the optimizer's configuration and the card's
name and power limit (nvidia-smi); and Adam's device time per update on the
flagship's parameters (``torch.profiler``), the port's fused one beside
PyTorch's default multi-tensor one with a float rate, which the port ran
before its step was recorded. A loss that is not finite exits 1. No TPU
constant appears: no ``vs_baseline``, no roofline.

``--device cpu`` takes ``--modes eager`` alone: a CUDA graph needs the
card, and asking for the captured mode there raises. A test runs
:func:`measure_path` so on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.ops.kernels import fused_attn, fused_dual_attn, fused_layer_step
from gasfm_tpu_torch.ops.kernels import fused_loss, fused_proj_update, fused_update
from gasfm_tpu_torch.ops.kernels import segment_kernels
from gasfm_tpu_torch.tools.profile_forward import SCENES, build_session, train_step
from gasfm_tpu_torch.train.state import FLAGSHIP_OPTIM, build_optimizer
from gasfm_tpu_torch.utils.device import resolve_device

# name -> (model of profile_forward.MODELS, scene of SCENES)
PATHS = {
    "gasfm-dense": ("gasfm", "dense"),
    "gasfm-powerlaw": ("gasfm", "powerlaw"),
    "gasfm-wide": ("gasfm", "wide"),
    "dpesfm-powerlaw": ("dpesfm", "powerlaw"),
    "gasfm-depth-dense": ("gasfm-depth", "dense"),
}
MODES = ("captured", "eager")
OPTIMIZER = "adam: f32, fused"
_MODULES = (fused_attn, fused_dual_attn, fused_layer_step, fused_loss, fused_proj_update,
            fused_update, segment_kernels)


def kernel_counters() -> Dict[str, Callable]:
    """The port's kernel wrappers, each with its ``launches`` counter (a
    wrapper that one module imports from another counted once)."""
    return {fn.__name__: fn for mod in _MODULES for fn in vars(mod).values()
            if callable(fn) and isinstance(getattr(fn, "launches", None), int)}


def launches_of(step: Callable[[], object]) -> int:
    """The port's kernel launches that ``step()`` counts."""
    counters = kernel_counters().values()
    before = sum(fn.launches for fn in counters)
    step()
    return sum(fn.launches for fn in counters) - before


def time_mode(session, scene, steps: int, rounds: int) -> Dict:
    """Two untimed steps, then ``rounds`` rounds of ``steps`` back-to-back
    steps of ``session`` on ``scene``: ms per step (the rounds' median and
    each round), edges/s, launches per step, peak memory, last loss."""
    dev = session.device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    out = {}

    def step():
        out["last"] = train_step(session, scene)

    first = launches_of(step)  # eager: the step; captured: the warm-up, run eagerly
    second = launches_of(step)  # captured: the recording (its replay counts nothing)
    sync()
    ms = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3 / steps)
    loss = float(out["last"][0])
    median = statistics.median(ms)
    E = scene.graph.num_edges
    return dict(ms_per_step=median, ms_per_step_rounds=ms, steps_per_round=steps,
                edges_per_s=E / median * 1e3,
                launches_per_step=second if session.capture else first,
                peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
                loss=loss, loss_finite=math.isfinite(loss))


def measure_path(build: Callable[[bool], object], scene, modes: Sequence[str] = MODES,
                 steps: int = 128, eager_steps: int = 20, rounds: int = 3) -> Dict:
    """Each of ``modes`` on a session from ``build(capture)`` (same weights
    each time), one after the other, each's memory freed before the next."""
    result = dict(views=scene.graph.num_cams, points=scene.graph.num_pts,
                  edges=scene.graph.num_edges)
    for mode in modes:
        session = build(mode == "captured")
        result[mode] = time_mode(session, scene, steps if mode == "captured" else eager_steps,
                                 rounds)
        del session
        gc.collect()  # a captured session's programs refer back to it
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if "captured" in result and "eager" in result:
        result["captured_speedup"] = (result["eager"]["ms_per_step"]
                                      / result["captured"]["ms_per_step"])
    return result


def adam_device_ms(params: Sequence[torch.Tensor], calls: int = 10) -> Dict[str, float]:
    """Device ms per update on copies of ``params`` (CUDA) with seeded
    gradients: the port's optimizer (fused Adam, the rate a tensor) and
    PyTorch's default Adam (multi-tensor, the rate a float)."""
    from gasfm_tpu_torch.tools.kernel_device_time import device_ms_per_call

    dev = params[0].device
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name in ("fused", "multi_tensor"):
        ps = [torch.nn.Parameter(p.detach().clone()) for p in params]
        grads = [1e-3 * torch.randn(p.shape, generator=gen, device=dev) for p in params]
        if name == "fused":
            opt = build_optimizer(ps, **FLAGSHIP_OPTIM)

            def update():
                opt.step(grads)
        else:
            adam = torch.optim.Adam(ps, lr=FLAGSHIP_OPTIM["lr"])

            def update():
                for p, g in zip(ps, grads):
                    p.grad = g
                adam.step()
        out[name] = device_ms_per_call(update, calls)[0]
    return out


def result_line(paths: Dict[str, Dict], device: str, smi: Optional[str],
                adam: Optional[Dict[str, float]] = None) -> Dict:
    """The bench's JSON line from :func:`measure_path`'s results."""
    def edges_per_s(name):
        return paths.get(name, {}).get("captured", {}).get("edges_per_s")

    return {"metric": "gasfm_train_edges_per_s", "value": edges_per_s("gasfm-dense"),
            "unit": "edges/s", "powerlaw_edges_per_s": edges_per_s("gasfm-powerlaw"),
            "optimizer": OPTIMIZER, "adam_device_ms_per_update": adam, "device": device,
            "nvidia_smi": smi, "paths": paths}


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS),
                    help=f"comma-separated, of {', '.join(PATHS)}")
    ap.add_argument("--modes", default=",".join(MODES), help="comma-separated, of captured, eager")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=128, help="captured steps per round")
    ap.add_argument("--eager-steps", type=int, default=20, help="eager steps per round")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names, modes = args.paths.split(","), args.modes.split(",")
    unknown = [n for n in names if n not in PATHS] + [m for m in modes if m not in MODES]
    if unknown:
        raise SystemExit(f"unknown paths or modes {unknown}; choose from {list(PATHS)}, {MODES}")
    if "captured" in modes and dev.type != "cuda":
        raise ValueError(f"the captured mode records CUDA graphs; on {dev} run --modes eager")
    scenes = {}
    results = {}
    for name in names:
        model, scene_name = PATHS[name]
        depth = model.endswith("-depth")
        if (scene_name, depth) not in scenes:
            t0 = time.perf_counter()
            scenes[(scene_name, depth)] = generate_synthetic_scene(
                **SCENES[scene_name], store_depth_targets=depth).to_scene_graph(device=dev)
            print(f"bench: scene {scene_name}{' with GT depths' if depth else ''} in "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        t0 = time.perf_counter()
        results[name] = measure_path(
            lambda capture: build_session(model, dev, capture=capture),
            scenes[(scene_name, depth)], modes, args.steps, args.eager_steps, args.rounds)
        print(f"bench: {name} in {time.perf_counter() - t0:.1f} s: "
              + "; ".join(f"{m} {results[name][m]['ms_per_step']:.3f} ms/step" for m in modes),
              file=sys.stderr)
    smi = adam = None
    kind = "cpu"
    if dev.type == "cuda":
        smi, kind = nvidia_smi_line(), torch.cuda.get_device_name(dev)
        adam = adam_device_ms(build_session("gasfm", dev, capture=False).params)
        print(f"bench: Adam on the flagship's parameters, device ms per update {adam}",
              file=sys.stderr)
    print(json.dumps(result_line(results, kind, smi, adam)))
    bad = [(n, m) for n, r in results.items() for m in modes if not r[m]["loss_finite"]]
    if bad:
        print(f"bench: loss not finite after the timed steps: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
