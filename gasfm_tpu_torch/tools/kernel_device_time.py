"""Device time per call of the layer step's forward (#5) and backward (#6),
the dual core's forward (#1) and backward (#2), the segment sum
(#15/#18), the segment max (#17/#19), the edge combine's backward (#12),
the row gather (#16/#20), the point side's single-direction attention
(#13, #14), the frontend's prologue (#3) and its backward (#4), the
projection update (#9) and its backward (#10), and the ESFM loss terms
(#7) and their backward (#8), from ``torch.profiler``, on both bench
scenes and the wide one, and of #6, #1, #2, #4, #7, #8, #9, #10, #12, the
segment sum and the segment max on the kernel-check graphs of
``chip_smoke.py`` (``graph/check_graphs.py``).

    python -m gasfm_tpu_torch.tools.kernel_device_time [--calls 20] [--out PATH]
        [--only NAME,NAME,...]

``--only`` measures only the rows of those names (the first field of a
row: ``segment_max``, ``scatter_reduce_``, ``frontend_prologue``,
``layer_step_prologue``, ``esfm_terms``, ``esfm_terms_bwd``, ...).

Each measurement profiles ``--calls`` back-to-back calls of one function
and nothing else, after a warm-up, and divides the summed device time of
every kernel in the window by the calls: so a function of several launches
is counted whole. A window counts once a second one caught the same
events of every kernel and none caught more (the profiler drops events
now and then); otherwise it is taken again, up to WINDOWS times, and then
that row is reported as not measured (with the events each window
caught), never as a time of 0 or a part of one, and the script exits
non-zero after the last row. Each row also carries a digest of
the function's outputs (SHA-1 of their bytes), so two trees' rows show
whether they compute the same bits. The layer step runs at the flagship's
interior shapes (en (E, 32), skip2 (E, 2), res (E, 32), W (32, 34), both
source linears 32 x 32): the forward's prologue alone
(``layer_step_prologue``, the dual core not in the window), the backward
from cotangents of xl_p, xl_c, e_norm_next and e_l (the dual core's
backward not in the window; also on every check graph); the dual core's
forward (``dual_attend_forward``, all its launches) at D = 32, H = 4, with
its residuals and without; its backward (``fused_dual_attend_bwd``, all its
launches) at D = 32, H = 4 from the forward's residuals (and on the degree
graph at four more (D, H)); the segment sum on both sides at D = 256, 32
and 4 (256 and 32 on the hub graphs), beside ``index_add_`` on the same
data; the segment max on both sides at D = 1, 4 and 8 (the default
neutral), on the bench, wide, hub-camera, hub-parts and degree graphs,
beside ``scatter_reduce_`` (amax) on the same data; the edge combine's
backward (``fused_edge_combine_bwd``, all its
launches: the point pass, the camera sums, the column sum, a merge launch
per side with a hub) at D = 256 and 32, also on the hub-point and
hub-parts graphs; the gather on both sides at D = 256 and D = 2, beside
``index_select`` on the same table and ids; the attention on the point side
at D = 32, H = 4 (an interior layer of the flagship on the unfused path),
the forward with its residuals (as under autograd) and the backward from
them; the frontend's prologue (#3) at the first layer's widths (De = 2,
Dp = Dc = 4, with the LayerNorm) and at De = Dp = Dc = 32 with the
LayerNorm and raw (also on the degree, hub-point and tile-boundary
graphs); the layer step's prologue (#5) also under raw and on the degree
and hub-point graphs; the frontend's backward
(``fused_frontend_bwd``, all its launches, from seeded cotangents of xl_p,
xl_c and e_norm) at the first layer's widths (De = 2, Dp = Dc = 4) and at
De = Dp = Dc = 32 with the LayerNorm and raw; the projection update with
skip2 and res, bare (d2 = 0, no res) and with res only; the projection
update's backward (``projection_update_bwd``, all its launches) at De =
d_in = 32, d2 = 2; these three on the bench scenes and the degree,
hub-point and tile-boundary graphs; the loss terms (``esfm_terms``, all
their launches) with the hinge and without, and their backward
(``esfm_terms_bwd``, all its launches) with the hinge in the three
equalization modes, on the bench and wide scenes and the empty-segment,
hub-camera, hub-point, degree and hub-parts graphs. Prints one line per measurement with each kernel's
launches and device time per call, and writes them as JSON to ``--out``
(default ``chiprun_out/kernel_device_time.json``).

It imports whichever ``gasfm_tpu_torch`` is first on the path, so one call
on the card can measure a parent tree and this one in turns: run it by
path from the other tree's root, ``PYTHONPATH=. python
<this tree>/gasfm_tpu_torch/tools/kernel_device_time.py``; it calls only
entry points whose names and signatures the parent trees share, and takes
its graphs from ``gasfm_tpu_torch/graph/check_graphs.py``, which a tree
older than that module gets as a copy of this tree's. The layer
step's backward took the saved ``en_next`` as an argument before it
recomputed it; the script passes it where the signature asks for it.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import inspect
import json
import subprocess
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.graph.check_graphs import (degree_graph, graph_with_empty_segments,
                                                hub_camera_graph, hub_parts_graph,
                                                hub_point_graph, tile_boundary_graph)
from gasfm_tpu_torch.ops.kernels import fused_attn as fat
from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda
from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls
from gasfm_tpu_torch.ops.kernels import fused_loss as flo
from gasfm_tpu_torch.ops.kernels import fused_proj_update as fpu
from gasfm_tpu_torch.ops.kernels import fused_update as fu
from gasfm_tpu_torch.ops.kernels import segment_kernels as sk
from gasfm_tpu_torch.tools.profile_forward import SCENES

# Profiler windows per measurement at most. On the H100 machines a window
# drops some or all of its kernel events now and then, a few windows in a
# row at times (1 to 8 in 60 windows of 20 calls of one kernel, some of 0
# events), whatever the code measured.
WINDOWS = 10


def device_ms_per_call(fn, calls):
    """(device ms per call summed over every kernel in the window, {kernel
    name: (launches, device ms) per call}). A window counts once a second
    window caught the same events of every kernel and no window caught more
    of any: the profiler drops some or all of a window's events now and then
    (``WINDOWS``), and a window that kept only some of them would report too
    little time. Every call launches at least one kernel, so a window with
    fewer CUDA events than calls never counts. Windows are taken again up to
    WINDOWS times in all; then it raises: an incomplete window is not a
    time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []  # per window: {kernel name: CUDA events}
    for _ in range(WINDOWS):
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
        counts = {k: n for k, (n, _) in names.items()}
        seen.append(counts)
        most = {k: max(c.get(k, 0) for c in seen) for c in seen for k in c}
        if sum(counts.values()) >= calls and counts == most and seen.count(counts) >= 2:
            total = sum(us for _, us in names.values())
            return total / calls / 1e3, {k: (n / calls, round(us / calls / 1e3, 4))
                                         for k, (n, us) in names.items()}
        if sum(counts.values()) < calls or counts != most:
            print(f"  device_ms_per_call: a window of {calls} calls caught {counts} CUDA events "
                  f"(the most of each kernel in any window: {most})", flush=True)
    raise RuntimeError(f"device_ms_per_call: {WINDOWS} profiler windows of {calls} calls each "
                       "caught fewer CUDA events than calls, or no two of them the most events "
                       "of every kernel")


def digest(out) -> str:
    """SHA-1 (16 hex digits) of the bytes of every tensor in ``out``."""
    h = hashlib.sha1()
    todo = [out]
    while todo:
        x = todo.pop(0)
        if isinstance(x, torch.Tensor):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        elif isinstance(x, (tuple, list)):
            todo[:0] = list(x)
    return h.hexdigest()[:16]


# ---- the calls ----------------------------------------------------------------


def step_operands(graph, dev, De=32, d_in=32, d2=2, res=True, seed=4321):
    """The layer step's operands at an interior layer's shapes (De wide, the
    next layer's source linears De -> De), seeded: a dict of en, skip2, res,
    w, b, ps, pv, pg, ln_scale, ln_bias, wlp, blp, wlc, blc."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return dict(en=torch.relu(rnd(E, d_in)), skip2=rnd(E, d2) if d2 else None,
                res=rnd(E, De) if res else None, w=rnd(De, d_in + d2, scale=0.2),
                b=rnd(De, scale=0.1), ps=rnd(n, De), pv=rnd(m, De), pg=rnd(1, De),
                ln_scale=1.0 + rnd(De, scale=0.2), ln_bias=rnd(De, scale=0.1),
                wlp=rnd(De, De, scale=0.2), blp=rnd(De, scale=0.1), wlc=rnd(De, De, scale=0.2),
                blc=rnd(De))


def layer_step_prologue_call(graph, dev, raw=False, **shape):
    """#5 alone, the interior form by default (``raw``: its raw prologue)."""
    ops = step_operands(graph, dev, **shape)
    return lambda: fls.layer_step_prologue(*ops.values(), graph, raw_prologue=raw)


def layer_step_bwd_call(graph, dev):
    """#6 at the flagship's interior shapes, its cotangents precomputed."""
    ops = step_operands(graph, dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    E, D = graph.num_edges, 32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    e_l, en_next, _, _ = fls.layer_step_prologue(*ops.values(), graph)
    kw = dict(en=ops["en"], skip2=ops["skip2"], w=ops["w"], e_l=e_l, ln_scale=ops["ln_scale"],
              ln_bias=ops["ln_bias"], wlp=ops["wlp"], wlc=ops["wlc"], graph=graph,
              dxl_p=rnd(E, D), dxl_c=rnd(E, D), den_next=rnd(E, D), de_l=rnd(E, D))
    if "en_next" in inspect.signature(fls.fused_layer_step_bwd).parameters:
        kw["en_next"] = en_next
    return lambda: fls.fused_layer_step_bwd(**kw)


def dual_fwd_call(graph, dev, D=32, heads=4, residuals=True, seed=3):
    """#1 (all its launches), both sides D wide with ``heads`` heads, with
    its residuals (as under autograd) or without (as a request calls it)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    ins = [torch.randn(shape, generator=gen, device=dev)
           for shape in ((E, D), (E, D), (n, D), (m, D), (D,), (D,))]
    return lambda: fda.dual_attend_forward(*ins, graph, heads, residuals=residuals)


def segment_sum_calls(graph, dev, widths=(256, 32, 4), seed=2468):
    """The segment sum on both sides at each width, each beside
    ``index_add_`` on the same data (the one PyTorch call of the same
    function)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for D in widths:
        for side in ("point", "camera"):
            ids, S = sk.side_ids(graph, side)
            x = torch.randn((graph.num_edges, D), generator=gen, device=dev)
            acc, ids64 = torch.zeros((S, D), device=dev), ids.long()
            cases.append(("segment_sum", f"{side}_D{D}",
                          lambda x=x, s=side: sk.segment_sum(x, graph, s)))
            cases.append(("index_add_", f"{side}_D{D}",
                          lambda x=x, a=acc, i=ids64: a.index_add_(0, i, x)))
    return cases


def dual_bwd_call(graph, dev, D=32, heads=4, seed=2):
    """#2 from the forward's residuals (as under autograd), both sides D
    wide with ``heads`` heads, its cotangents seeded."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    xl_p, xl_c, xr_p, xr_c, att_p, att_c, g_p, g_c = (
        torch.randn(shape, generator=gen, device=dev)
        for shape in ((E, D), (E, D), (n, D), (m, D), (D,), (D,), (n, D), (m, D)))
    out_p, out_c, res, ins = fda.dual_attend_forward(xl_p, xl_c, xr_p, xr_c, att_p, att_c,
                                                     graph, heads, residuals=True)
    return lambda: fda.fused_dual_attend_bwd(*ins, out_p, out_c, *res, g_p, g_c, graph, heads)


FRONTEND_FORMS = {"De2_Dq4": (2, 4, False), "De32": (32, 32, False),
                  "De32_raw": (32, 32, True)}


def frontend_call(graph, dev, form="De32", seed=613):
    """#3's per-edge prologue at (De, Dq, raw) = FRONTEND_FORMS[form]: the
    LayerNorm (De,) unless raw, the source linears Dq x De on both sides;
    De2_Dq4 is the first layer's (the embedded uv)."""
    De, Dq, raw = FRONTEND_FORMS[form]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    ops = (rnd(graph.num_edges, De, scale=2.0), 1.0 + rnd(De, scale=0.2), rnd(De, scale=0.1),
           rnd(Dq, De, scale=0.3), rnd(Dq, scale=0.1), rnd(Dq, De, scale=0.3),
           rnd(Dq, scale=0.1))
    return lambda: fda.frontend_prologue(*ops, raw_prologue=raw)


def segment_max_calls(graph, dev, widths=(1, 4, 8), seed=97531):
    """The segment max on both sides at each width (the default neutral,
    -inf), each beside ``scatter_reduce_`` (amax) on the same data (the one
    PyTorch call of the same function)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for D in widths:
        for side in ("point", "camera"):
            ids, S = sk.side_ids(graph, side)
            x = torch.randn((graph.num_edges, D), generator=gen, device=dev)
            acc = torch.full((S, D), float("-inf"), device=dev)
            idx = ids.long()[:, None].expand(-1, D).contiguous()
            cases.append(("segment_max", f"{side}_D{D}",
                          lambda x=x, s=side: sk.segment_max(x, graph, s)))
            cases.append(("scatter_reduce_", f"{side}_D{D}",
                          lambda x=x, a=acc, i=idx: a.scatter_reduce_(0, i, x, reduce="amax",
                                                                      include_self=False)))
    return cases


def projection_update_bwd_call(graph, dev, seed=97):
    """#10 whole (all its launches) at the depth flagship's layer L-2 shapes
    (De = d_in = 32, d2 = 2), from a seeded cotangent."""
    ops = step_operands(graph, dev)
    g = torch.randn((graph.num_edges, 32), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    return lambda: fpu.projection_update_bwd(g, ops["en"], ops["skip2"], ops["w"], graph)


def edge_combine_bwd_calls(graph, dev, widths=(256, 32), seed=2468):
    """#12 whole (all its launches: the point pass, the camera sums, the
    column sum, and a merge launch per side with a hub) at each width."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    gs = {D: torch.randn((graph.num_edges, D), generator=gen, device=dev) for D in widths}
    return [("fused_edge_combine_bwd", f"D{D}", lambda g=g: fu.fused_edge_combine_bwd(g, graph))
            for D, g in gs.items()]


PROJECTION_UPDATE_FORMS = {"skip2_res": dict(d2=2, res=True), "bare": dict(d2=0, res=False),
                           "res_only": dict(d2=0, res=True)}


def projection_update_call(graph, dev, form="skip2_res"):
    """#9 at De = d_in = 32 in one of PROJECTION_UPDATE_FORMS: with the
    2-wide skip2 and the residual, with neither, with the residual only."""
    ops = step_operands(graph, dev, **PROJECTION_UPDATE_FORMS[form])
    return lambda: fpu.projection_update(*(ops[k] for k in (
        "en", "skip2", "res", "w", "b", "ps", "pv", "pg")), graph)


FRONTEND_BWD_FORMS = {"De2_Dq4": (2, 4, False), "De32_Dq32": (32, 32, False),
                      "De32_Dq32_raw": (32, 32, True)}


def frontend_bwd_call(graph, dev, form="De2_Dq4", seed=531):
    """#4 whole (all its launches) at (De, Dq, raw) = FRONTEND_BWD_FORMS[form]:
    the source linears Dq x De on both sides, from seeded cotangents of
    xl_p, xl_c and (not under raw) e_norm."""
    De, Dq, raw = FRONTEND_BWD_FORMS[form]
    gen = torch.Generator(device=dev).manual_seed(seed)
    E = graph.num_edges

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    e, lng, lnb = rnd(E, De, scale=2.0), 1.0 + rnd(De, scale=0.2), rnd(De, scale=0.1)
    wlp, blp, wlc, blc = rnd(Dq, De, scale=0.3), rnd(Dq), rnd(Dq, De, scale=0.3), rnd(Dq)
    dxl_p, dxl_c, den = rnd(E, Dq), rnd(E, Dq), None if raw else rnd(E, De)
    en = fda.frontend_prologue(e, lng, lnb, wlp, blp, wlc, blc, raw_prologue=raw)[0]
    return lambda: fda.fused_frontend_bwd(e, lng, lnb, wlp, wlc, dxl_p, dxl_c, den, en,
                                          raw_prologue=raw)


def loss_calls(graph, dev, seed=8642):
    """#7 (``esfm_terms_forward``, all its launches) with the hinge and
    without, and #8 (``fused_esfm_terms_bwd``, all its launches) with the
    hinge in the three equalization modes: cameras near [I | (0, 0, 3)], a
    fifth of them flipped, points in a unit box (depths of both signs),
    margin 1e-4, the cotangent 1 / E."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m, n = graph.num_cams, graph.num_pts

    def rnd(*shape):
        return 0.1 * torch.randn(shape, generator=gen, device=dev)

    P = torch.cat([torch.eye(3, device=dev) + rnd(m, 3, 3),
                   torch.tensor([[0.0], [0.0], [3.0]], device=dev) + rnd(m, 3, 1)], dim=2)
    P = (P * torch.where(torch.arange(m, device=dev) % 5 == 0, -1.0, 1.0)[:, None, None]
         ).reshape(m, 12).contiguous()
    X = torch.cat([torch.rand((n, 3), generator=gen, device=dev) * 2 - 1,
                   torch.ones((n, 1), device=dev)], dim=1)
    terms = flo.esfm_terms_forward(P, X, graph, 1e-4, True, 1.0)[0]
    coef = torch.full((1,), 1.0 / max(graph.num_edges, 1), device=dev)
    cases = [("esfm_terms", variant, lambda h=hinge: flo.esfm_terms_forward(
                  P, X, graph, 1e-4, h, 1.0 if h else 0.0)[0])
             for variant, hinge in (("hinge", True), ("no_hinge", False))]
    for mode in ("valid_only", "all", "none"):
        count = terms[2:3] if mode == "valid_only" else terms[1:2]
        cases.append(("esfm_terms_bwd", mode, lambda mode=mode, count=count:
                      flo.fused_esfm_terms_bwd(P, X, graph, coef, count, 1e-4, True, 1.0, mode)))
    return cases


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
    ap.add_argument("--only", default="", help="comma-separated row names to measure")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_device_time: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}; package {Path(fls.__file__).resolve().parents[2]}")
    out = []

    def measure(label, name, variant, fn):
        if only and name not in only:
            return
        try:
            ms, names = device_ms_per_call(fn, args.calls)
        except RuntimeError as exc:  # a row without a time, not a time of 0
            print(f"{label} {name}[{variant}]: not measured ({exc})", flush=True)
            out.append(dict(scene=label, name=name, variant=variant, error=str(exc)))
            return
        dig = digest(fn())
        print(f"{label} {name}[{variant}]: device {ms:.4f} ms per call; digest {dig}; per call "
              f"(launches, device ms) by kernel {names}", flush=True)
        out.append(dict(scene=label, name=name, variant=variant, device_ms_per_call=ms,
                        launches_per_call=names, digest=dig))

    with torch.no_grad():
        graphs = {}
        for scene_name in ("dense", "powerlaw", "wide"):
            graph = generate_synthetic_scene(**SCENES[scene_name]).to_scene_graph(device=dev).graph
            graphs[scene_name] = graph
            gen = torch.Generator(device=dev).manual_seed(2468)
            cases = attend_calls(graph, dev)
            cases.append(("fused_layer_step_bwd", "interior", layer_step_bwd_call(graph, dev)))
            cases += segment_sum_calls(graph, dev)
            cases += segment_max_calls(graph, dev)
            cases += edge_combine_bwd_calls(graph, dev)
            cases += loss_calls(graph, dev)
            if scene_name != "wide":  # the merged path's kernels
                for resid in (True, False):
                    cases.append(("fused_dual_attend", "D32_H4" + ("_residuals" if resid else ""),
                                  dual_fwd_call(graph, dev, residuals=resid)))
                cases.append(("layer_step_prologue", "interior",
                              layer_step_prologue_call(graph, dev)))
                cases.append(("layer_step_prologue", "interior_raw",
                              layer_step_prologue_call(graph, dev, raw=True)))
                cases.append(("fused_dual_attend_bwd", "D32_H4", dual_bwd_call(graph, dev)))
                for form in FRONTEND_FORMS:
                    cases.append(("frontend_prologue", form, frontend_call(graph, dev, form)))
                for form in FRONTEND_BWD_FORMS:
                    cases.append(("fused_frontend_bwd", form, frontend_bwd_call(graph, dev, form)))
                for form in PROJECTION_UPDATE_FORMS:
                    cases.append(("projection_update", form,
                                  projection_update_call(graph, dev, form)))
                cases.append(("projection_update_bwd", "skip2",
                              projection_update_bwd_call(graph, dev)))
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
                measure(scene_name, name, variant, fn)
        # the kernel-check graphs of chip_smoke.py
        extra = {"dense_empty": graph_with_empty_segments(graphs["dense"]),
                 "hub_camera": hub_camera_graph(graphs["dense"]),
                 "degrees": degree_graph(graphs["powerlaw"])}
        extra["hub_point"] = hub_point_graph(graphs["wide"])
        extra["hub_parts"] = hub_parts_graph(dev)
        for label, graph in extra.items():
            measure(label, "fused_layer_step_bwd", "interior", layer_step_bwd_call(graph, dev))
            for name, variant, fn in loss_calls(graph, dev):
                measure(label, name, variant, fn)
            if label in ("hub_camera", "hub_parts", "degrees"):
                for name, variant, fn in segment_max_calls(graph, dev):
                    measure(label, name, variant, fn)
            if label in ("degrees", "hub_point"):
                for form in FRONTEND_FORMS:
                    measure(label, "frontend_prologue", form, frontend_call(graph, dev, form))
                measure(label, "layer_step_prologue", "interior",
                        layer_step_prologue_call(graph, dev))
                measure(label, "projection_update_bwd", "skip2",
                        projection_update_bwd_call(graph, dev))
                for form in PROJECTION_UPDATE_FORMS:
                    measure(label, "projection_update", form,
                            projection_update_call(graph, dev, form))
                for form in FRONTEND_BWD_FORMS:
                    measure(label, "fused_frontend_bwd", form, frontend_bwd_call(graph, dev, form))
            if label in ("hub_point", "hub_parts"):
                for name, variant, fn in edge_combine_bwd_calls(graph, dev):
                    measure(label, name, variant, fn)
            if label == "hub_parts":
                continue
            if label != "hub_point":
                for resid in (True, False):
                    measure(label, "fused_dual_attend", "D32_H4" + ("_residuals" if resid else ""),
                            dual_fwd_call(graph, dev, residuals=resid))
                measure(label, "fused_dual_attend_bwd", "D32_H4", dual_bwd_call(graph, dev))
            if label != "dense_empty":
                for name, variant, fn in segment_sum_calls(graph, dev, widths=(256, 32)):
                    measure(label, name, variant, fn)
        for D, H in ((16, 4), (32, 1), (8, 8), (12, 6)):
            measure("degrees", "fused_dual_attend_bwd", f"D{D}_H{H}",
                    dual_bwd_call(extra["degrees"], dev, D=D, heads=H))
        tiles = tile_boundary_graph(dev)
        measure("tile_edges", "fused_layer_step_bwd", "interior", layer_step_bwd_call(tiles, dev))
        measure("tile_edges", "projection_update_bwd", "skip2",
                projection_update_bwd_call(tiles, dev))
        for form in PROJECTION_UPDATE_FORMS:
            measure("tile_edges", "projection_update", form,
                    projection_update_call(tiles, dev, form))
        for form in FRONTEND_BWD_FORMS:
            measure("tile_edges", "fused_frontend_bwd", form, frontend_bwd_call(tiles, dev, form))
        measure("tile_edges", "layer_step_prologue", "interior",
                layer_step_prologue_call(tiles, dev))
        measure("tile_edges", "layer_step_prologue", "narrow_De8",
                layer_step_prologue_call(tiles, dev, De=8, d_in=8))
        for form in FRONTEND_FORMS:
            measure("tile_edges", "frontend_prologue", form, frontend_call(tiles, dev, form))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, rows=out), indent=1))
    missing = [f"{r['scene']} {r['name']}[{r['variant']}]" for r in out if "error" in r]
    if missing:
        raise SystemExit(f"kernel_device_time: not measured: {missing}")


if __name__ == "__main__":
    main()
