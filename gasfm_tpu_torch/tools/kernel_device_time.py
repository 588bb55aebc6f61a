"""Device time per call of the layer step's backward (#6), the row gather
(#16/#20) and the point side's single-direction attention (#13, #14), from
``torch.profiler``, on both bench scenes and the wide one.

    python -m gasfm_tpu_torch.tools.kernel_device_time [--calls 20] [--out PATH]

Each measurement profiles ``--calls`` back-to-back calls of one function
and nothing else, after a warm-up, and divides the summed device time of
every kernel in the window by the calls: so a function of several launches
is counted whole. The layer step's backward runs at the flagship's interior
shapes (en (E, 32), skip2 (E, 2), W (32, 34), both source linears 32 x 32,
cotangents of xl_p, xl_c, e_norm_next and e_l; the dual core's backward is
not in the window); the gather on both sides at D = 256 and D = 2, beside
``index_select`` on the same table and ids; the attention on the point side
at D = 32, H = 4 (an interior layer of the flagship on the unfused path),
the forward with its residuals (as under autograd) and the backward from
them. Prints one line per measurement with each kernel's launches and
device time per call, and writes them as JSON to ``--out`` (default
``chiprun_out/kernel_device_time.json``).

It imports whichever ``gasfm_tpu_torch`` is first on the path, so one call
on the card can measure a parent tree and this one in turns: run it by
path from the other tree's root, ``PYTHONPATH=. python
<this tree>/gasfm_tpu_torch/tools/kernel_device_time.py``. The layer step's backward took
the saved ``en_next`` as an argument before it recomputed it; the script
passes it where the signature asks for it.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import subprocess
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.ops.kernels import fused_attn as fat
from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls
from gasfm_tpu_torch.ops.kernels import segment_kernels as sk
from gasfm_tpu_torch.tools.profile_forward import SCENES


def device_ms_per_call(fn, calls):
    """(device ms per call summed over every kernel in the window, {kernel
    name: (launches, device ms) per call})."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = collections.defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            k = names[evt.name.split("(")[0][:70]]
            k[0] += 1
            k[1] += evt.time_range.elapsed_us()
    total = sum(us for _, us in names.values())
    return total / calls / 1e3, {k: (n / calls, round(us / calls / 1e3, 4))
                                 for k, (n, us) in names.items()}


def layer_step_bwd_call(graph, dev):
    """#6 at the flagship's interior shapes, its cotangents precomputed."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    E, n, m, D = graph.num_edges, graph.num_pts, graph.num_cams, 32

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    en, skip2, res = torch.relu(rnd(E, D)), rnd(E, 2), rnd(E, D)
    w, b = rnd(D, D + 2, scale=0.2), rnd(D, scale=0.1)
    ps, pv, pg = rnd(n, D), rnd(m, D), rnd(1, D)
    ln_scale, ln_bias = 1.0 + rnd(D, scale=0.2), rnd(D, scale=0.1)
    wlp, blp, wlc, blc = rnd(D, D, scale=0.2), rnd(D, scale=0.1), rnd(D, D, scale=0.2), rnd(D)
    e_l, en_next, _, _ = fls.layer_step_prologue(en, skip2, res, w, b, ps, pv, pg, ln_scale,
                                                 ln_bias, wlp, blp, wlc, blc, graph)
    kw = dict(en=en, skip2=skip2, w=w, e_l=e_l, ln_scale=ln_scale, ln_bias=ln_bias, wlp=wlp,
              wlc=wlc, graph=graph, dxl_p=rnd(E, D), dxl_c=rnd(E, D), den_next=rnd(E, D),
              de_l=rnd(E, D))
    if "en_next" in inspect.signature(fls.fused_layer_step_bwd).parameters:
        kw["en_next"] = en_next
    return lambda: fls.fused_layer_step_bwd(**kw)


def attend_calls(graph, dev, heads=4, D=32):
    """#13 (the forward with residuals) and #14 (the backward from them) on
    the point side, through the wrapper calls the parent trees have too."""
    gen = torch.Generator(device=dev).manual_seed(1357)
    S = graph.num_pts
    xl, xr, att, g = (torch.randn(shape, generator=gen, device=dev)
                      for shape in ((graph.num_edges, D), (S, D), (D,), (S, D)))
    out, res, saved = fat.attend_forward(xl, xr, att, graph, "point", heads, residuals=True)
    return [("fused_attend", f"point_D{D}_H{heads}", lambda: fat.attend_forward(
                xl, xr, att, graph, "point", heads, residuals=True)),
            ("fused_attend_bwd", f"point_D{D}_H{heads}", lambda: fat.fused_attend_bwd(
                *saved, out, *res, g, graph, "point", heads))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/kernel_device_time.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_device_time: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}; package {Path(fls.__file__).resolve().parents[2]}")
    out = []
    with torch.no_grad():
        for scene_name in ("dense", "powerlaw", "wide"):
            graph = generate_synthetic_scene(**SCENES[scene_name]).to_scene_graph(device=dev).graph
            gen = torch.Generator(device=dev).manual_seed(2468)
            cases = attend_calls(graph, dev)
            cases.append(("fused_layer_step_bwd", "interior", layer_step_bwd_call(graph, dev)))
            for D in (256, 2):
                for side in ("point", "camera"):
                    ids, S = sk.side_ids(graph, side)
                    table = torch.randn((S, D), generator=gen, device=dev)
                    ids64 = ids.long()
                    cases.append(("gather_rows", f"{side}_D{D}",
                                  lambda t=table, s=side: sk.gather_rows(t, graph, s)))
                    cases.append(("index_select", f"{side}_D{D}",
                                  lambda t=table, i=ids64: torch.index_select(t, 0, i)))
            for name, variant, fn in cases:
                ms, names = device_ms_per_call(fn, args.calls)
                print(f"{scene_name} {name}[{variant}]: device {ms:.4f} ms per call; per call "
                      f"(launches, device ms) by kernel {names}")
                out.append(dict(scene=scene_name, name=name, variant=variant,
                                device_ms_per_call=ms, launches_per_call=names))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, rows=out), indent=1))


if __name__ == "__main__":
    main()
