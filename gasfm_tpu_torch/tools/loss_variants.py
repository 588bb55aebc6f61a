"""Device time per call of design variants of the ESFM loss terms' kernels
(``csrc/fused_loss.cu``: the forward #7, the backward #8) beside the shipped
design, in one process on one card, so that each choice of the design is
measured against its alternatives on the same card:

    python -m gasfm_tpu_torch.tools.loss_variants [--calls 20] [--turns 2] [--out PATH]

Each variant is this tree's ``fused_loss.cu`` with a few exact lines
replaced, built with nvcc (``build.NVCC_FLAGS``, one process per variant,
in parallel) into ``_build/loss_variants/<name>/``, and bound in place of
the shipped library for its turn (with the wrapper's matching constants,
``TERMS_EDGES`` and ``LONG_POINT``). A replacement that no longer matches
the source raises: the variants describe this tree's kernels and are
rebuilt from them, never timed from a stale copy.

Forward variants (the hinge on): two launches (no ticket; a one-block
launch sums the partials), ``__threadfence`` around a relaxed ``atomicInc``
in place of the acquire-release increment, 1 and 4 edges per thread,
512-thread blocks; and two diagnostics whose output is not the loss: the
pass alone (no block merges the partials) and the pass without the camera
and point gathers (constant rows). Backward variants (valid_only
equalization): 2 and 4 camera rows in flight, 4 point rows, the points'
long threshold at 16, 24 and 64 edges, 4- and 16-warp blocks, a launch
per side (cameras, then points), the points' blocks before the cameras'.
On the dense, power-law and wide scenes and on the hub-camera and
hub-parts graphs, ``--turns`` turns over all variants.
Prints each variant's device ms per call (``kernel_device_time``'s
profiler windows, every launch of a call counted) and output digest, and
writes them as JSON to ``--out`` (default
``chiprun_out/loss_variants.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch

from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.graph.check_graphs import hub_camera_graph, hub_parts_graph
from gasfm_tpu_torch.ops.kernels import build as kb
from gasfm_tpu_torch.ops.kernels import fused_loss as flo
from gasfm_tpu_torch.tools.kernel_device_time import device_ms_per_call, digest, loss_calls
from gasfm_tpu_torch.tools.profile_forward import SCENES

OUT = kb.BUILD_DIR / "loss_variants"

TICKET = "    last = ticket_inc(ticket, nb - 1) == nb - 1;"
MERGE_KERNEL = """
__global__ void __launch_bounds__(kTermsThreads) merge_partials_kernel(
    const float* __restrict__ partials, int nb, float* __restrict__ out) {
  __shared__ float sw[3][kTermsWarps];
  float t[3] = {0.f, 0.f, 0.f};
  for (int b = threadIdx.x; b < nb; b += kTermsThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] += partials[3 * (size_t)b + k];
  }
  block_sum3(t, sw);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = t[k];
  }
}

// ---- backward"""
CAM_ROWS = "      float4 x;\n      float2 o;\n    };\n    static constexpr int kAhead = 3;"
PT_ROWS = "      float4 p0, p1, p2;\n      float2 o;\n    };\n    static constexpr int kAhead = 2;"
BWD_BOUNDS = "__launch_bounds__(kLossBwdWarps * 32, kSumBlockWarps / kLossBwdWarps)"
BWD_WARPS = "constexpr int kLossBwdWarps = kMaxBlockWarps;"


def _swap(old, a, b):
    return old, old.replace(a, b)


def _warps(n):
    return [(BWD_WARPS, f"constexpr int kLossBwdWarps = {n};"),
            (BWD_BOUNDS, f"__launch_bounds__(kLossBwdWarps * 32, {32 // n})")]


# name: (kernel, source replacements, wrapper constants)
VARIANTS = {
    "shipped": ("both", [], {}),
    "fwd_two_launches": ("forward", [
        (TICKET, "    last = false;"),
        ("\n// ---- backward", MERGE_KERNEL),
        ("      ticket, out);\n  return",
         "      ticket, out);\n  merge_partials_kernel<<<1, kTermsThreads, 0, "
         "(cudaStream_t)stream>>>(partials, nb, out);\n  return")], {}),
    "fwd_threadfence": ("forward", [
        (TICKET, "    __threadfence();\n    last = atomicInc(ticket, nb - 1) == nb - 1;"),
        ("  if (!last) return;\n", "  if (!last) return;\n  __threadfence();\n")], {}),
    "fwd_edges1": ("forward", [_swap("constexpr int kTermsEdges = 2;", "2", "1")],
                   {"TERMS_EDGES": 256}),
    "fwd_edges4": ("forward", [_swap("constexpr int kTermsEdges = 2;", "2", "4")],
                   {"TERMS_EDGES": 1024}),
    "fwd_threads512": ("forward", [_swap("constexpr int kTermsThreads = 256;", "256", "512")],
                       {"TERMS_EDGES": 1024}),
    "fwd_pass_alone": ("forward", [(TICKET, "    last = false;")], {}),
    "fwd_no_gathers": ("forward", [(
        "      p[j][0] = __ldg(pc);\n      p[j][1] = __ldg(pc + 1);\n"
        "      p[j][2] = __ldg(pc + 2);\n      x[j] = __ldg(X4 + pt[j]);",
        "      p[j][0] = make_float4(1.f, 0.f, 0.f, (float)cam[j]);\n"
        "      p[j][1] = make_float4(0.f, 1.f, 0.f, 0.f);\n"
        "      p[j][2] = make_float4(0.f, 0.f, 1.f, 2.f);\n"
        "      x[j] = make_float4(o[j].x, o[j].y, 1.f, (float)pt[j]);\n      (void)pc;")], {}),
    "bwd_cam_rows2": ("backward", [_swap(CAM_ROWS, "= 3", "= 2")], {}),
    "bwd_cam_rows4": ("backward", [_swap(CAM_ROWS, "= 3", "= 4")], {}),
    "bwd_pt_rows4": ("backward", [_swap(PT_ROWS, "= 2", "= 4")], {}),
    "bwd_pt_long16": ("backward", [_swap("constexpr int kLossLongPoint = 32;", "32", "16")],
                      {"LONG_POINT": 16}),
    "bwd_pt_long24": ("backward", [_swap("constexpr int kLossLongPoint = 32;", "32", "24")],
                      {"LONG_POINT": 24}),
    "bwd_pt_long64": ("backward", [_swap("constexpr int kLossLongPoint = 32;", "32", "64")],
                      {"LONG_POINT": 64}),
    "bwd_warps4": ("backward", _warps(4), {}),
    "bwd_warps16": ("backward", _warps(16), {}),
    "bwd_launch_per_side": ("backward", [
        ("    esfm_terms_bwd_kernel<<<grid, kLossBwdWarps * 32, 0, s>>>(\n"
         "        a, cam_ptr, cam_perm, csp, n_cams, pt_ptr, psp, n_pts, E, cam_blocks,",
         "    esfm_terms_bwd_kernel<<<cam_blocks, kLossBwdWarps * 32, 0, s>>>(\n"
         "        a, cam_ptr, cam_perm, csp, n_cams, pt_ptr, psp, n_pts, E, cam_blocks, dP,\n"
         "        cam_part, dX, pt_part);\n"
         "    esfm_terms_bwd_kernel<<<grid - cam_blocks, kLossBwdWarps * 32, 0, s>>>(\n"
         "        a, cam_ptr, cam_perm, csp, n_cams, pt_ptr, psp, n_pts, E, 0,")], {}),
    "bwd_points_first": ("backward", [
        ("  if ((int)blockIdx.x < cam_blocks) {\n"
         "    segment_sum_block<12, 1, false, SumRed, kLossBwdWarps>(\n        blockIdx.x,",
         "  if ((int)blockIdx.x >= (int)gridDim.x - cam_blocks) {\n"
         "    segment_sum_block<12, 1, false, SumRed, kLossBwdWarps>(\n"
         "        blockIdx.x - (gridDim.x - cam_blocks),"),
        ("        blockIdx.x - cam_blocks, EdgeGradRows<false>{a}",
         "        blockIdx.x, EdgeGradRows<false>{a}")], {}),
}


def variant_source(replacements):
    src = (kb.CSRC / "fused_loss.cu").read_text()
    for old, new in replacements:
        if src.count(old) != 1:
            raise RuntimeError("loss_variants: a replacement no longer matches "
                               f"fused_loss.cu:\n{old}")
        src = src.replace(old, new)
    return src


def build_variants():
    """{name: {symbol: bound C entry}}, every variant built in parallel."""
    procs = {}
    for name, (_, replacements, _) in VARIANTS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kb.CSRC, d)
        (d / "fused_loss.cu").write_text(variant_source(replacements))
        cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "fused_loss.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=open(d / "nvcc.log", "w"),
                                       stderr=subprocess.STDOUT)
    entries = {}
    for name, proc in procs.items():
        log = (OUT / name / "nvcc.log")
        if proc.wait():
            raise RuntimeError(f"loss_variants: nvcc failed for {name}:\n{log.read_text()[-3000:]}")
        lines = log.read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "esfm_terms" in line:
                print(f"{name}: {line.split(chr(39))[1][:40]} "
                      + " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]))
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        entries[name] = {"gasfm_esfm_terms": kb.bind(lib, "gasfm_esfm_terms", flo._ARGS),
                         "gasfm_esfm_terms_bwd": kb.bind(lib, "gasfm_esfm_terms_bwd",
                                                         flo._BWD_ARGS)}
    return entries


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/loss_variants.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loss_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    entries = build_variants()
    base = {k: generate_synthetic_scene(**SCENES[k]).to_scene_graph(device=dev).graph
            for k in ("dense", "powerlaw", "wide")}
    graphs = dict(base, hub_camera=hub_camera_graph(base["dense"]), hub_parts=hub_parts_graph(dev))
    shipped = {k: getattr(flo, k) for k in ("_entry", "TERMS_EDGES", "LONG_POINT")}
    rows = []
    with torch.no_grad():
        for label, graph in graphs.items():
            calls = {(name, variant): fn for name, variant, fn in loss_calls(graph, dev)}
            fns = {"forward": calls["esfm_terms", "hinge"],
                   "backward": calls["esfm_terms_bwd", "valid_only"]}
            for turn in range(1, args.turns + 1):
                for name, (kernel, _, consts) in VARIANTS.items():
                    flo._entry = lambda symbol="gasfm_esfm_terms", e=entries[name]: e[symbol]
                    for k, v in consts.items():
                        setattr(flo, k, v)
                    try:
                        for which in ("forward", "backward"):
                            if kernel not in (which, "both"):
                                continue
                            ms, launches = device_ms_per_call(fns[which], args.calls)
                            dig = digest(fns[which]())
                            print(f"{label} turn {turn} {name} {which}: device {ms:.4f} ms per "
                                  f"call; digest {dig}; {launches}", flush=True)
                            rows.append(dict(scene=label, turn=turn, variant=name, kernel=which,
                                             device_ms_per_call=ms, digest=dig,
                                             launches_per_call=launches))
                    finally:
                        for k, v in shipped.items():
                            setattr(flo, k, v)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, rows=rows), indent=1))


if __name__ == "__main__":
    main()
