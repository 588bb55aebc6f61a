#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gasfm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Device and build: the card's name and power limit (nvidia-smi), CUDA
   present, the kernels built from ``gasfm_tpu_torch/csrc`` with nvcc for
   sm_90a (build seconds and ptxas's register report).
2. Each kernel against its plain PyTorch version on the card, on seeded
   inputs at the flagship shapes of both bench scenes: max error against
   the stated tolerance, median time over CUDA events, the plain version's
   time, and the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, whichever is larger).
3. The slice: the flagship GraphAttnSfMNet (9 layers, 4 heads, widths
   32/64/1024/2048, seeded init) answers 3 requests per scene through
   ``TrainingSession.forward`` and ``.loss`` on the dense (128 views, 8192
   points) and power-law (133 views, 24,576 points) synthetic scenes. The
   launch counters are zeroed just before and read just after; the exact
   counts per forward are checked. Outputs must be finite, the kernel path
   must agree with the plain path on the card, and on a small scene with
   the plain path on the CPU.
4. A ``kernels`` JSON line, the nvidia-smi line, and the final
   ``{"ok": true, "device": ...}`` line. The full record goes to
   ``chiprun_out/chip_smoke.json``.

Tolerances, all float32 with sums in another order than the plain version:
per kernel |err| <= 1e-5 x scale + 1e-4 x |ref|; for the 9-layer forward
and the loss |err| <= 1e-3 x scale + 1e-3 x |ref| (nine layers of flax-form
LayerNorms amplify rounding on edges whose features nearly coincide).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-3
REQUESTS = 3
KERNELS = {  # name -> (source in the repo, the TPU kernel's pallas_call it replaces)
    "fused_dual_attend": ("gasfm_tpu_torch/csrc/fused_dual_attn.cu",
                          "gasfm_tpu/ops/pallas/fused_dual_attn.py:325"),
    "fused_frontend": ("gasfm_tpu_torch/csrc/fused_dual_attn.cu",
                       "gasfm_tpu/ops/pallas/fused_dual_attn.py:1023"),
    "fused_layer_step": ("gasfm_tpu_torch/csrc/fused_layer_step.cu",
                         "gasfm_tpu/ops/pallas/fused_layer_step.py:689"),
    "fused_esfm_terms": ("gasfm_tpu_torch/csrc/fused_loss.cu",
                         "gasfm_tpu/ops/pallas/fused_loss.py:253"),
}


class SmokeFailure(RuntimeError):
    pass


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want, rtol, atol):
    """(max |got - want|, within |err| <= atol * scale + rtol * |want|)."""
    got, want = got.double(), want.double()
    if got.shape != want.shape or not torch.isfinite(got).all():
        return float("inf"), False
    scale = max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol * scale + rtol * want.abs()).all())


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_phase(dev, scene_name, graph, model, record):
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls
    from gasfm_tpu_torch.ops.kernels import fused_loss as flo

    gen = torch.Generator(device=dev).manual_seed(1234)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    H = model.equivariant_blocks[0].global_feature_update.n_heads

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    csr = (graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
    results = {}

    def check(name, variant, kernel, plain, outs, io_bytes, flops, main):
        got, want = kernel(), plain()
        worst, ok, ref = 0.0, True, 0.0
        for o, g, w in zip(outs, got, want):
            e, good = max_err(g, w, KERNEL_RTOL, KERNEL_ATOL)
            worst, ok, ref = max(worst, e), ok and good, max(ref, float(w.abs().max()))
            if not good:
                print(f"  {name}[{variant}] {o}: max err {e:.3e} out of tolerance")
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        b_ms, b_by = bound_ms(io_bytes, flops)
        print(f"kernel {name}[{variant}] {scene_name}: max_abs_err {worst:.3e} (max |ref| {ref:.4g}) "
              f"(tol {KERNEL_ATOL:g} x scale + {KERNEL_RTOL:g} x |ref|) "
              f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        record.setdefault("kernel_variants", []).append(dict(
            scene=scene_name, name=name, variant=variant, max_abs_err=worst, max_abs_ref=ref, ok=ok, ms=ms,
            plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by))
        entry = results.setdefault(name, dict(max_abs_err=0.0, ok=True))
        entry["max_abs_err"] = max(entry["max_abs_err"], worst)
        entry["ok"] = entry["ok"] and ok
        if main:
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, variant=variant)

    # #1 dual core at an interior layer's shapes (D = 32 both sides).
    D = 32
    xl_p, xl_c, xr_p, xr_c = rnd(E, D), rnd(E, D), rnd(n, D), rnd(m, D)
    att_p, att_c = rnd(D), rnd(D)
    args = (xl_p, xl_c, xr_p, xr_c, att_p, att_c, graph, H)
    check("fused_dual_attend", "D32", lambda: fda.fused_dual_attend(*args),
          lambda: fda.fused_dual_attend_plain(*args), ("out_pt", "out_cam"),
          nbytes(xl_p, xl_c, xr_p, xr_c, att_p, att_c, *csr) + 4 * (n + m) * D,
          10.0 * E * 2 * D, True)

    # #3 frontend: layer 0 of the model itself (De = 2, the embedded uv,
    # D = 4), then De = 32 with LN and raw (random parameters).
    blk0 = model.equivariant_blocks[0]
    gfu = blk0.global_feature_update
    cp, cc = gfu.proj2scenepoint.graph_conv, gfu.proj2view.graph_conv
    e0 = model.embed(graph.uv)
    f0 = (e0, blk0.prev_projfeat_norm_layer.weight, blk0.prev_projfeat_norm_layer.bias,
          cp.lin_l.weight, cp.lin_l.bias, cc.lin_l.weight, cc.lin_l.bias,
          cp.transform_dst(None, n), cc.transform_dst(None, m),
          cp.att.reshape(-1), cc.att.reshape(-1), graph, H)
    front_variants = [("De2_layer0", f0, False, True)]
    e32 = rnd(E, 32)
    f32 = (e32, 1.0 + rnd(32, scale=0.2), rnd(32, scale=0.1), rnd(D, 32, scale=0.2),
           rnd(D, scale=0.1), rnd(D, 32, scale=0.2), rnd(D, scale=0.1), xr_p, xr_c,
           att_p, att_c, graph, H)
    front_variants += [("De32_ln", f32, False, False), ("De32_raw", f32, True, False)]
    for variant, fa, raw, main in front_variants:
        e, Dq = fa[0], fa[3].shape[0]
        # inputs read once (LayerNorm operands only when used), outputs
        # written once: e_norm (not under raw), out_pt, out_cam
        io = nbytes(e, *(() if raw else fa[1:3]), *fa[3:11], *csr) \
            + (0 if raw else nbytes(e)) + 4 * (n + m) * Dq
        flops = E * (8 * e.shape[1] + 4 * e.shape[1] * Dq + 20 * Dq)
        check("fused_frontend", variant,
              lambda fa=fa, raw=raw: fda.fused_frontend(*fa, raw_prologue=raw),
              lambda fa=fa, raw=raw: fda.fused_frontend_plain(*fa, raw_prologue=raw),
              ("e_norm", "out_pt", "out_cam"), io, flops, main)

    # #5 layer step: interior (skip2 = e0, res), first-layer form, final raw.
    en32, res = torch.relu(rnd(E, 32)), rnd(E, 32)
    tables = (rnd(n, 32), rnd(m, 32), rnd(1, 32))
    ln = (1.0 + rnd(32, scale=0.2), rnd(32, scale=0.1))
    front = (rnd(D, 32, scale=0.2), rnd(D, scale=0.1), rnd(D, 32, scale=0.2), rnd(D, scale=0.1),
             xr_p, xr_c, att_p, att_c, graph, H)
    step_variants = [
        ("interior", (en32, e0, res, rnd(32, 34, scale=0.2)), False, True),
        ("first_layer", (torch.relu(e0), e0, None, rnd(32, 4, scale=0.5)), False, False),
        ("final_raw", (en32, e0, res, rnd(32, 34, scale=0.2)), True, False),
    ]
    for variant, (en, skip2, res_, w), raw, main in step_variants:
        sa = (en, skip2, res_, w, rnd(32, scale=0.1), *tables, *ln, *front)
        io = nbytes(*sa[:8], *(() if raw else ln), *front[:8], graph.pt_idx, graph.cam_idx,
                    *csr) + 4 * E * 32 * (1 if raw else 2) + 4 * (n + m) * D
        flops = E * (2 * w.shape[1] * 32 + 8 * 32 + 4 * 32 * D + 20 * D)
        check("fused_layer_step", variant,
              lambda sa=sa, raw=raw: fls.fused_layer_step(*sa, raw_prologue=raw),
              lambda sa=sa, raw=raw: fls.fused_layer_step_plain(*sa, raw_prologue=raw),
              ("e_l", "e_norm_next", "out_pt", "out_cam"), io, flops, main)

    # #7 loss terms, hinge on (the flagship loss) and off. Cameras near
    # [I | (0, 0, 3)], a fifth of them flipped, and points in a unit box give
    # depths of both signs, all well away from the margin.
    P = torch.cat([torch.eye(3, device=dev) + rnd(m, 3, 3, scale=0.1),
                   torch.tensor([[0.0], [0.0], [3.0]], device=dev) + rnd(m, 3, 1, scale=0.1)], dim=2)
    P = (P * torch.where(torch.arange(m, device=dev) % 5 == 0, -1.0, 1.0)[:, None, None])
    P = P.reshape(m, 12).contiguous()
    X = torch.cat([torch.rand((n, 3), generator=gen, device=dev) * 2 - 1,
                   torch.ones((n, 1), device=dev)], dim=1)
    for variant, hinge, main in (("hinge", True, True), ("no_hinge", False, False)):
        la = (P, X, graph, 1e-4, hinge, 1.0 if hinge else 0.0)
        check("fused_esfm_terms", variant, lambda la=la: (flo.fused_esfm_terms(*la),),
              lambda la=la: (flo.fused_esfm_terms_plain(*la),), ("terms",),
              nbytes(P, X, graph.uv, graph.cam_idx, graph.pt_idx) + 12, 40.0 * E, main)
    return results


# ---------------------------------------------------------------------------
# phase 3: the slice
# ---------------------------------------------------------------------------


def slice_phase(dev, session, scenes, counters, record):
    L = len(session.model.equivariant_blocks)
    per_request = {"fused_frontend": 1, "fused_layer_step": L, "fused_dual_attend": L + 1,
                   "fused_esfm_terms": 1}
    outputs = {}
    for fn in counters.values():
        fn.launches = 0
    for name, scene in scenes.items():
        before = {k: fn.launches for k, fn in counters.items()}
        times = []
        for _ in range(REQUESTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred = session.forward(scene)
            loss = session.loss(pred, scene)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        outputs[name] = (pred, loss)
        delta = {k: fn.launches - before[k] for k, fn in counters.items()}
        want = {k: REQUESTS * v for k, v in per_request.items()}
        if delta != want:
            raise SmokeFailure(f"{name}: launches {delta}, expected {want}")
        E = scene.graph.num_edges
        ms = statistics.median(times)
        print(f"slice {name}: {scene.graph.num_cams} views, {scene.graph.num_pts} points, "
              f"{E} edges; {REQUESTS} requests, ms/request {[round(t, 3) for t in times]} "
              f"(median {ms:.3f} ms, {E / ms * 1e3:.4g} edges/s); loss {float(loss):.6f}; "
              f"launches {delta}")
        record.setdefault("slice", {})[name] = dict(
            views=scene.graph.num_cams, points=scene.graph.num_pts, edges=E,
            ms_per_request=times, median_ms=ms, edges_per_s=E / ms * 1e3,
            loss=float(loss), launches=delta)
    launches = {k: fn.launches for k, fn in counters.items()}  # read just after the main path

    for name, scene in scenes.items():
        pred, loss = outputs[name]
        ref = session.forward(scene, plain=True)
        ref_loss = session.loss(ref, scene, plain=True)
        g = scene.graph
        if pred["Ps_norm"].shape != (g.num_cams, 3, 4) or pred["pts3D"].shape != (4, g.num_pts):
            raise SmokeFailure(f"{name}: output shapes {[tuple(v.shape) for v in pred.values()]}")
        errs = {}
        for key, got, want in (("Ps_norm", pred["Ps_norm"], ref["Ps_norm"]),
                               ("pts3D", pred["pts3D"], ref["pts3D"]),
                               ("loss", loss.reshape(1), ref_loss.reshape(1))):
            err, ok = max_err(got, want, SLICE_RTOL, SLICE_ATOL)
            errs[key] = err
            if not ok:
                raise SmokeFailure(f"{name}: {key} kernel vs plain max err {err:.3e} "
                                   f"out of tolerance")
        print(f"slice {name}: kernel vs plain path on the card, max abs err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol {SLICE_ATOL:g} x scale + {SLICE_RTOL:g} x |ref|) ok")
        record["slice"][name]["kernel_vs_plain_max_abs_err"] = errs
    return launches


def small_scene_check(dev, session, record):
    """The kernel path on the card against the plain path on the CPU, same
    weights, on a small scene."""
    import copy

    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.train.loop import TrainingSession

    data = generate_synthetic_scene(n_views=8, n_points=600, visibility=0.5, seed=9)
    cpu = TrainingSession(copy.deepcopy(session.model).cpu(), session.loss_func, device="cpu")
    want_scene = data.to_scene_graph(device="cpu")
    want = cpu.forward(want_scene)
    want_loss = cpu.loss(want, want_scene)
    scene = data.to_scene_graph(device=dev)
    got = session.forward(scene)
    got_loss = session.loss(got, scene)
    errs = {}
    for key, g, w in (("Ps_norm", got["Ps_norm"], want["Ps_norm"]),
                      ("pts3D", got["pts3D"], want["pts3D"]),
                      ("loss", got_loss.reshape(1), want_loss.reshape(1))):
        err, ok = max_err(g.cpu(), w, SLICE_RTOL, SLICE_ATOL)
        errs[key] = err
        if not ok:
            raise SmokeFailure(f"small scene: {key} card vs CPU max err {err:.3e}")
    print("small scene (8 views, 600 points): kernel path on the card vs plain path on "
          "the CPU, max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " ok")
    record["small_scene_card_vs_cpu_max_abs_err"] = errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.losses import ESFMLoss
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
    from gasfm_tpu_torch.ops.kernels import build
    from gasfm_tpu_torch.ops.kernels.fused_dual_attn import fused_dual_attend, fused_frontend
    from gasfm_tpu_torch.ops.kernels.fused_layer_step import fused_layer_step
    from gasfm_tpu_torch.ops.kernels.fused_loss import fused_esfm_terms
    from gasfm_tpu_torch.tools.profile_forward import FLAGSHIP, SCENES
    from gasfm_tpu_torch.train.loop import TrainingSession

    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")
    record = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__}

    # ---- phase 1: build
    t0 = time.perf_counter()
    seconds = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, per source {dict((k, round(v, 1)) for k, v in seconds.items())}")
    for name in build.SOURCES:
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    record["build_s"] = build_s

    # ---- scenes and model
    t0 = time.perf_counter()
    datas = {k: generate_synthetic_scene(**kw) for k, kw in SCENES.items()}
    model = GraphAttnSfMNet(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    session = TrainingSession(model, ESFMLoss(1e-4, True, 1.0), device=dev)
    scenes = {k: d.to_scene_graph(device=dev) for k, d in datas.items()}
    print(f"setup: scenes and model in {time.perf_counter() - t0:.1f} s; "
          f"{sum(p.numel() for p in model.parameters())} parameters")

    # ---- phase 2: kernels against their plain versions, at both scenes'
    # shapes; the kernels line reports the dense scene's.
    with torch.no_grad():
        per_scene = {k: kernel_phase(dev, k, scenes[k].graph, session.model, record)
                     for k in scenes}
    results = per_scene["dense"]
    bad = [(s, k) for s, r in per_scene.items() for k, v in r.items() if not v["ok"]]
    if bad:
        raise SmokeFailure(f"kernels out of tolerance: {bad}")

    # ---- phase 3: the slice
    counters = {"fused_dual_attend": fused_dual_attend, "fused_frontend": fused_frontend,
                "fused_layer_step": fused_layer_step, "fused_esfm_terms": fused_esfm_terms}
    launches = slice_phase(dev, session, scenes, counters, record)
    for name, count in launches.items():
        if count == 0:
            raise SmokeFailure(f"{name} was never launched on the main path")
    small_scene_check(dev, session, record)

    # ---- phase 4: the record
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None))
    record["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
