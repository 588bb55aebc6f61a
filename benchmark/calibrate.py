"""The readings that the limits of a cell's comparison are set from.

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,3
        [--program-only] [--out chiprun_out/calibrate_<cell>.jsonl]

Per seed, at the cell's own size on the card, the numbers that
``benchmark.check`` compares:

- ``program``: a sound run of the program (``benchmark.run.measure`` with a
  short window), the lower reading's source;
- ``control``: the reference computed in float32 with TF32 matrix
  products, the nearest precision below the configurations' float32, put
  in the program's place;
- ``reference_float32``: the reference computed in float32 (TF32 off) in
  the program's place: a second sound float32 implementation;
- ``half_edges``: the reference with the loss taken over half of the
  observations, the mean over the rest, in the program's place;
- ``reference_again``: the reference run a second time (its sums on the
  card are not bitwise repeatable).

``--program-only`` takes the first alone, for the further seeds of the
lower reading. A state left unchanged reads 1 on ``grad_leaf`` and
``update_leaf`` by their definition and needs no run. One JSON line per
seed and kind, with the card's peak memory of that kind's run.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec
    from benchmark.check import gaps, worst_leaves
    from benchmark.reference.graph import build_graph
    from benchmark.reference.train import model_class, train_steps
    from benchmark.run import measure
    from benchmark.scene import generate
    from benchmark.weights import make_weights

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    cell = spec.load(args.workload)
    skip = cell.config.get("two_wide_stream_leaves", ())
    out = Path(args.out or f"chiprun_out/calibrate_{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    with out.open("a") as f:
        def emit(seed, what, numbers, seconds, prog=None, ref=None):
            line = {"workload": args.workload, "seed": seed, "kind": what, "numbers": numbers,
                    "seconds": seconds, "device": kind,
                    "peak_bytes": torch.cuda.max_memory_allocated()}
            torch.cuda.reset_peak_memory_stats()
            if prog is not None:
                line["worst"] = {k: worst_leaves(prog, ref, k, skip=skip)
                                 for k in ("grad_leaf", "change_leaf")}
            line = json.dumps(line)
            print(line, flush=True)
            f.write(line + "\n")

        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            run = measure(cell, seed, 0.5, False, "cuda", t)
            emit(seed, "program", run["numbers"], time.perf_counter() - t, run["prog"],
                 run["ref"])
            if args.program_only:
                continue
            scene = generate(cell.traffic, seed)
            graph = build_graph(scene.M, scene.Ns, "cuda")
            with torch.device("meta"):
                model = model_class(cell.config["reference"])(cell.config["conf"]["model"])
            weights = make_weights(model, seed, "cuda", cell.config.get("fixed_weights"))
            t = time.perf_counter()
            ref = train_steps(cell.config, graph, weights)
            ref_s = time.perf_counter() - t
            emit(seed, "reference", {"seconds": ref_s}, ref_s)
            for what, kw in (("reference_again", {}),
                             ("reference_float32", dict(dtype=torch.float32)),
                             ("control", dict(tf32=True, dtype=torch.float32)),
                             ("half_edges", dict(half_edges=True))):
                t = time.perf_counter()
                other = train_steps(cell.config, graph, weights, **kw)
                emit(seed, what, gaps(other, ref, skip), time.perf_counter() - t, other, ref)
            del graph, weights, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
