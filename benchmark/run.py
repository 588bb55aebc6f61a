"""The port's benchmark: single-scene training steps through ``epoch_train``.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json``, in one process, on one card:

1. Set-up. The scene from the cell's traffic file and ``--seed``
   (``benchmark.scene``), the weights on the card from the seed
   (``benchmark.weights``), the program's session on the configuration's
   conf with those weights (``benchmark.program``), the scene's graph, and
   three steps through ``epoch_train``: the eager step, the recording and
   the first replay. Every shape of the window is warm after them.
2. The window (``--trace 0``): back-to-back steps through ``epoch_train``
   for ``--seconds``, then the last step waited for. ``step_ms`` is the
   window's wall time over its steps; ``step_ms_p95`` the 95th percentile
   of the intervals between the returns of ``epoch_train``. With
   ``--trace 1`` the window is a profiled run of as many steps as take
   0.3 s, and the per-layer metrics are read from it (``benchmark/metrics/``).
3. The check. Once the window has closed and the peak memory is read, the
   program is freed and the plain reference (``benchmark/reference/``)
   takes the same first three steps from the same weights on the same
   scene; ``benchmark.check`` compares the program's readings of those
   steps with it.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (steps), ``metrics``, ``device`` and with
``--trace 1`` ``breakdown``; the numbers compared, each beside its limit,
come last in it and on standard error. Without a card, or with fewer cards
than the cell asks for, or with JAX loaded, the run prints no result and
exits non-zero.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gasfm_tpu")
SETUP_STEPS = 3
ADAM_B1 = 0.9  # after one step Adam's first moment is (1 - b1) times the gradient
TRACE_S = 0.3  # a traced window spans at least this long on the host's clock
TRACE_MIN_STEPS = 8


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 1


def shape_of(scene, device) -> dict:
    """The sizes that the counts take: observations, points, cameras, the
    observations per point and per camera, the card's multiprocessors."""
    import numpy as np
    import torch

    m = scene.M.shape[0] // 2
    xy = scene.M.reshape(m, 2, -1)
    valid = np.abs(xy).sum(axis=1) != 0
    valid[:, valid.sum(axis=0) < 2] = False
    shape = {"E": int(valid.sum()), "n": scene.M.shape[1], "m": m,
             "pt_deg": valid.sum(axis=0), "cam_deg": valid.sum(axis=1)}
    if device.type == "cuda":
        shape["sms"] = torch.cuda.get_device_properties(device).multi_processor_count
    return shape


def leaf_norms(tensors: dict, minus: Optional[dict] = None) -> dict:
    """Each tensor's norm (of its difference from ``minus``'s), one tensor
    at a time, so that no copy of all of them is held."""
    import torch

    norms = [torch.linalg.vector_norm(t if minus is None else t.detach() - minus[k])
             for k, t in tensors.items()]
    return dict(zip(tensors, torch.stack(norms).tolist()))


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            program_hook=None) -> dict:
    """One run; returns the result line's parts. ``program_hook(program)``
    may change the program after it is built (the tests plant faults)."""
    import torch

    from benchmark.check import gaps, judge
    from benchmark.program import Program
    from benchmark.reference.graph import build_graph
    from benchmark.reference.train import model_class, train_steps
    from benchmark.scene import generate
    from benchmark.trace import Window, device_synchronize, traced_window
    from benchmark.weights import make_weights

    device = torch.device(device)
    sync = device_synchronize(device)
    config = cell.config

    def weights():
        with torch.device("meta"):
            model = model_class(config["reference"])(config["conf"]["model"])
        return make_weights(model, seed, device, config.get("fixed_weights"))

    # 1. set-up
    scene = generate(cell.traffic, seed)
    program = Program(config, scene, weights(), device)
    if program_hook is not None:
        program_hook(program)
    spans = {}
    t = time.perf_counter()
    program.graph()
    sync()
    spans["graph"] = time.perf_counter() - t
    t = time.perf_counter()
    firsts = [program.step()]
    first_grad = {k: v / (1.0 - ADAM_B1) for k, v in leaf_norms(program.first_moments()).items()}
    for _ in range(SETUP_STEPS - 1):
        firsts.append(program.step())
    change = leaf_norms(program.named_params(), minus=weights())
    sync()
    spans["record"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    # 2. the window. The peak memory is what the program holds on the card
    # through it: the caching allocator's reserved bytes, which take in the
    # CUDA graphs' private pools (their activations are allocated while
    # recording and never again while replaying, so the allocated peak
    # would leave them out)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = None
    steps = 0
    if not trace:
        marks = [time.perf_counter()]
        while marks[-1] - marks[0] < seconds:
            program.step()
            marks.append(time.perf_counter())
        program.scalars(program.carried)
        end = time.perf_counter()
        steps = len(marks) - 1
        intervals = [b - a for a, b in zip(marks, marks[1:])]
        step_ms = 1e3 * (end - marks[0]) / steps
        p95_ms = 1e3 * statistics.quantiles(intervals, n=20)[-1] if steps > 1 else step_ms
    else:
        t = time.perf_counter()
        for _ in range(TRACE_MIN_STEPS):
            program.step()
        sync()
        per_step = (time.perf_counter() - t) / TRACE_MIN_STEPS
        steps = max(TRACE_MIN_STEPS, math.ceil(TRACE_S / per_step))
        if device.type == "cuda":
            window = traced_window(program.step, steps, sync)
        else:  # no card to trace (the tests): the host's clock alone
            t = time.perf_counter()
            for _ in range(steps):
                program.step()
            window = Window(steps, time.perf_counter() - t)
        program.scalars(program.carried)
        steps += TRACE_MIN_STEPS
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0

    # the program's readings of the first steps, then the program freed
    scalars = [program.scalars(c) for c in firsts]
    prog = {"loss": [s[0] for s in scalars], "repro": [s[1] for s in scalars],
            "grad_norm": [s[2] for s in scalars], "grad_leaf": first_grad,
            "change_leaf": change}
    program.close()
    del program, firsts
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 3. the check
    ref = train_steps(config, build_graph(scene.M, scene.Ns, device), weights(), SETUP_STEPS)
    numbers = gaps(prog, ref, config.get("two_wide_stream_leaves", ()))
    correct = judge(numbers, cell.limits)

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "step_ms": step_ms, "step_ms_p95": p95_ms}
    else:
        counts = importlib.import_module(config["counts"])
        shape = shape_of(scene, device)
        readings = SimpleNamespace(
            window=window, spans=spans, kernel_launches=counts.kernel_launches(
                config["conf"]["model"], shape),
            model_flops=counts.model_flops(config["conf"]["model"], shape))
        values = {m.name: m.read(readings) for m in cell.per_layer}
    units = {m.name: m.unit for m in cell.end_to_end + cell.per_layer}
    for name, value in values.items():
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    return dict(correct=correct, steps=steps, metrics=metrics, peak=peak, window=window,
                numbers=numbers, limits=cell.limits, prog=prog, ref=ref)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import spec

    try:
        cell = spec.load(args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(f"the cell cannot be read: {e}")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"the cell needs {cell.chips} CUDA device(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    from benchmark.program import missing

    if missing():
        return fail(f"the program is not in this checkout: {missing()}")
    out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    loaded = forbidden_modules()
    if loaded:
        return fail(f"modules of JAX or the JAX package were loaded: {loaded}")
    if args.trace and out["window"] is None:
        return fail("no profiler window caught a kernel launch")
    print(json.dumps(result_line(out, bool(args.trace), torch.cuda.get_device_name(0))))
    return 0


def result_line(out: dict, trace: bool, kind: str) -> dict:
    """The run's result line; the numbers compared, beside their limits,
    come last, and on standard error too."""
    from benchmark.check import report

    compared = report(out["numbers"], out["limits"])
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": int(out["peak"])}
    line = {"correct": bool(out["correct"]), "attempted": SETUP_STEPS + out["steps"],
            "failed": 0 if out["correct"] else SETUP_STEPS, "metrics": out["metrics"],
            "device": device}
    if trace and out["window"] is not None:
        device.update(busy_s=out["window"].busy_s, window_s=out["window"].window_s)
        line["breakdown"] = out["window"].breakdown()
    line["compared"] = compared
    for name, c in compared.items():
        mark = "within" if c["value"] <= c["limit"] else "OVER"
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r} {mark}", file=sys.stderr)
    return line


if __name__ == "__main__":
    sys.exit(main())
