#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gasfm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Device and build: the card's name and power limit (nvidia-smi), CUDA
   present, the kernels built from ``gasfm_tpu_torch/csrc`` with nvcc for
   sm_90a, one process per source in parallel (build seconds and ptxas's
   register report).
2. Each GASFM forward kernel against its plain PyTorch version on the card,
   on seeded inputs at the flagship shapes of both bench scenes: max error
   against the stated tolerance; two times of the kernel, per call (the
   median over CUDA events around one call, the host's launch path
   included) and in a burst (events around 100 back-to-back calls after a
   warm-up, divided by 100: the device's time wherever the host keeps
   ahead); the plain version's time, and the least time the card could
   take (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
   whichever is larger). The dual core (#1) is launched twice, bitwise,
   without residuals and with them (each side's per-head max and
   denominator against the plain logits'). The layer step's prologue
   (#5), the kernel its wrapper launches before the dual core, is also
   held alone against its plain version in each form and launched twice,
   bitwise; the kernels line takes its numbers from the interior form. So
   is the frontend's prologue (#3): the whole frontend and the prologue
   alone, each twice, bitwise, at the model's own layer 0 (De = 2, Dp = Dc
   = 4: the narrow form, a lane per edge) and at De = 32 with the LayerNorm
   and raw (the tile form); the kernels line takes its numbers from the
   prologue alone at layer 0.
3. Each GASFM backward kernel against autograd of its plain version on the
   card, on seeded inputs and cotangents at both scenes' shapes: the dual
   core at D = 32, the frontend at layer 0 (De = 2, Dq = 4) and at De = Dq
   = 32 with the LayerNorm and raw (the depth head's widening layer), the
   layer step in its interior, first-layer and raw-prologue forms, the loss
   in its three equalization modes (the loss's forward, #7, and backward,
   #8, launched twice, bitwise, also on the wide scene, the dense scene
   with empty segments, the dense scene plus a camera over all 8,192 points
   and 4,500 cameras with a point on all). The max error of every input gradient,
   the backward kernels' per-call and burst times, the plain backward's
   time and the bound. The frontend's backward (#4) and the layer step's
   (#6) are timed alone (the dual core's backward ahead of each
   precomputed), each bound counted for its own whole function (weight
   gradients included), and two launches of each must agree bitwise; its three forms also run on a graph built for its tiles
   of 32 edges: one point's edges span four tiles, 57 points and one
   camera have no edges, and E is not a multiple of 32; so does #5's, at
   the flagship's width and at De = Dp = Dc = 8. The dual core's backward
   (#2) is launched twice, bitwise; it and the forward (#1, twice, with
   and without residuals) also run on graphs that stress their split of
   both CSRs at 32 edges: the dense scene with empty segments, the dense
   scene plus a camera over all 8,192 points, and the power-law scene plus
   cameras of exactly 31, 32, 33 and 64 edges and a point of 133 (there
   also at (D, H) = (16, 4), (32, 1), (8, 8), (12, 6)); the device time
   per call of each on the hub-camera graph must be at most 1.5x the dense
   scene's.
3b. The DPESFM path's kernels at both scenes' shapes: the segment sum on
   both sides (point, camera) at D = 2, 4, 32 and 256 and the row gather at
   D = 2 and 256, each launched twice (bitwise equal), also timed per call
   and in a burst against the one PyTorch call of the same function
   (``index_add_``, ``index_select``; the gather's 8 variants bitwise equal
   to the plain version, and at D = 256 on the point side the host's
   microseconds per call split by the wrapper's steps); the edge combine at
   D = 256 and its backward (#12) at D = 2, 4, 32 and 256 against autograd
   of its plain version (d pe bitwise), twice, bitwise. #12 also runs at
   those widths, twice, bitwise, on the wide scene, the wide scene plus a
   point in all 1280 views and points of 63-128 edges, 4,500 cameras with a
   point on all (its point walk's merge launch), the power-law scene plus
   cameras of 31-64 edges and a point of 133, and the dense scene with
   empty segments; its device time per call at D = 256 on the hub-point
   graph must be at most 1.5x the wide scene's (printed beside the parent
   design's). The segment sum also runs, both sides at D = 2, 4, 32 and 256, twice,
   bitwise, on the wide scene and on graphs that stress its split (a
   segment of more than 64 rows takes a block, one of more than 2048 rows
   several, merged by a second launch): the dense scene plus a camera over
   all its 8,192 points, the power-law scene plus cameras of 31-64 edges and
   a point of 133, the wide scene plus a point in all 1280 views and points
   of 63, 64, 65 and 128 edges, and 4,500 cameras with a point on all of
   them (on the point side a hub of three parts); its device time per call
   on each of the first three, both sides at D = 32 and 256, must be at
   most 1.5x its base scene's.
3c. The kernels GASFM's unfused path adds, on the dense scene and the wide
   one (1280 views, 16,384 power-law points): the single-direction attention
   on both sides at D = 32, forward (and its max and denominator residuals
   against the plain logits') and backward, each launched twice bitwise, on
   the wide scene also on a copy with empty segments and on a hub graph
   (the wide scene plus a point seen by all 1280 cameras and points of
   exactly L - 1, L, L + 1 and 2L edges, L the point side's split length;
   there also at (D, H) = (16, 4), (32, 1), (8, 8), (12, 6) and (6, 3)),
   with #13's and #14's device times per call on the wide and hub graphs
   (the hub graph must cost less than 1.5x the wide one); and the segment
   max on both sides at D = 1, 4 and 8, on the graph and on a copy with
   empty segments, bitwise, twice, also timed against ``scatter_reduce_``
   (amax); the max also on the graphs that stress the split it walks (the
   segment sum's): the dense scene plus a camera over all 8,192 points
   (four parts and the merge launch), 4,500 cameras with a point on all
   (three parts) and the power-law scene plus cameras of 31-64 edges and a
   point of 133.
3d. The standalone projection update (the depth path's layer L-2) on both
   bench scenes at De = 32: with the 2-wide skip2 and the residual, with
   neither, and at d2 = 0 with the residual, against its plain version,
   twice, bitwise; its backward (#10) against autograd of the plain
   version, every input's gradient, twice, bitwise. The same three forms
   also run on the tile-boundary graph, the power-law scene plus cameras of
   31-64 edges and a point of 133, the wide scene plus a point in all 1280
   views, and the dense scene with empty segments; the frontend's backward
   (#4) in its three forms on the first three of these, and its forward
   (#3, whole and alone, twice, bitwise) on the first two. No single
   PyTorch call computes any of these (no library time).
4. GASFM serving: the flagship GraphAttnSfMNet (9 layers, 4 heads, widths
   32/64/1024/2048, seeded init) answers 3 requests per scene through
   ``TrainingSession.forward`` and ``.loss`` on the dense (128 views, 8192
   points) and power-law (133 views, 24,576 points) synthetic scenes. The
   launch counters are zeroed just before and read just after; the exact
   counts per request are checked (no backward launch, no residual write).
   Outputs must be finite and agree with the plain path on the card.
5. GASFM training, a main path: ``TrainingSession.fused_step`` on each
   scene, one warm-up step then 3 timed steps, at full width and depth, with
   the flagship conf's loss (margin 1e-4, hinge weight 1, valid-only
   gradient equalization) and optimizer (Adam, lr 1e-4, 2,500 warm-up
   steps, exponential decay 0.1 over 35,000). Counters zeroed just before,
   read just after; exact launches per step (forward: frontend 1, layer
   step 9, dual 10, loss 1; backward: loss 1, layer step 9, frontend 1,
   dual 10; our_repro's gathers 3 in each timed step). Prints ms per step,
   edges/s, loss, our_repro, grad norm and peak device memory. A twin of
   the model on the plain path, from the same weights, must agree: every
   parameter gradient at the first step, the loss at every step.
6. A small scene (8 views, 600 points): the GASFM kernel path on the card
   against the plain path on the CPU, forward and after 3 training steps.
6b. The unfused layer through the dual kernel: ``use_norm_proj_update =
   false`` with a projection-update MLP, 2 layers, on the dense scene; one
   request and one step's gradients with exact launches, against the plain
   path and a float64 plain run.
6c-6d. The same flagship model object on the wide scene, which it runs
   unfused (more than 1024 cameras): 3 requests (per request the
   single-direction attention 10, segment max 10, gather 20, segment sum
   10, edge combine 9, loss 1; no frontend, layer-step or dual launch),
   then training 1 + 3 steps as in phase 5 (per step also attention
   backward 10, gather 10, segment sum 10, edge-combine backward 9, loss
   backward 1, and our_repro's gathers 3).
7-9. The same for DPESFM, the set-of-sets baseline at the widths of
   ``confs/dpesfm/learning_euc_noaug_dpesfm.conf`` (one block of three
   layers, 256 wide, seeded init) with its loss (equalization over all
   edges) and optimizer (Adam, lr 1e-3, multistep): 3 serving requests per
   scene (per request segment sum 8, edge combine 3, loss 1, no gather and
   no backward), training 1 + 3 steps per scene (per step also edge-combine
   backward 3, gather 6 for the means' backward plus 3 for our_repro, loss
   backward 1), the small scene card vs CPU.
10-11. The depth flagship: the same GASFM with the conf's depth head (128
   wide, 2 hidden layers) and no view or scenepoint head, DirectDepthLoss
   (L1) on the scenes' GT depths (host DLT triangulation, its seconds
   printed). Serving, 3 requests per merged scene; per request frontend 2
   (layers 0 and 8), layer step 7, dual 9, projection update 1 (layer 7),
   edge combine 1 (layer 8, 128 wide), no loss kernel. Training through
   ``loss_and_grads`` + ``update`` (the JAX package's loop for a depth-only
   model), 1 + 3 steps per scene; per step also frontend backward 2, layer
   step backward 7, dual backward 9, projection-update backward 1,
   edge-combine backward 1. s_pred (the mean predicted depth, whose inverse
   scales the loss) is printed, the depth models seeded where it is not
   small (``DEPTH_SEEDS``); the step-1 gradient rule takes the largest
   error of 3 plain float32 runs as its yardstick, and also allows, per
   tensor, the most its L1 ties can move it (the edges whose sign differs
   from the float64 run's, counted and printed).
12. DPESFM with the depth head on the dense scene: serving (per request
   segment sum 6, edge combine 3) and training 1 + 3 steps (per step also
   edge-combine backward 3, gather 4), as above.
12b. The training step recorded as CUDA graphs, the session's default on
   the card (the phases above build theirs with ``capture=False``), on
   every training path: merged GASFM dense and power-law, GASFM wide,
   DPESFM power-law, the depth flagship dense (``loss_and_grads`` and
   ``update``, two graphs). Two eager sessions and a captured one from the
   same weights take 1 + 3 steps side by side (the captured one's warm-up,
   its recording, two replays): per step loss, our_repro, grad norm and
   every parameter, captured against eager bitwise where the two eager runs
   agree bitwise, else within phase 6's tolerances (it prints which held);
   exact launches (the warm-up and the recording a step's each, a replay
   none), and the kernel operands that the wrappers' validation copied in
   the recording (each a launch per replay) printed. Then 200 more replays: each kept loss unchanged by the next
   replay, losses finite, and every 50 replays the step's loss against a
   forward's taken just before (the loss's ticket counter at 0 at each
   replay's start). Then a checkpoint, 2 steps, a restore in place (no
   tensor moved), the same 2 steps: equal under the same rule, on the same
   graphs. ms per step captured and eager (median of 3), launches and peak
   memory printed.
14. Sessions built from the shipped confs (``load_config`` ->
   ``init_model`` -> ``TrainingSession.from_conf``, captured, the session's
   default): the flagship (``confs/gasfm/optim_euc_gasfm.conf``, dense
   scene) and DPESFM (``confs/dpesfm/learning_euc_noaug_dpesfm.conf``,
   power-law scene) each against its preset session from a generator of
   the same seed, ``state_dict`` bitwise, then 2 and 1 + 3 captured steps
   bitwise. The projective flagship (``confs/gasfm/optim_proj_gasfm.conf``:
   ``calibrated = false``, "Differentiable Chirality"; full width) on the
   dense scene generated uncalibrated: its forward kernels against their
   plain versions as in phase 2, 3 requests with exact launches as in phase
   4, training 1 + 3 steps as in phase 5 (exact launches, step-1 gradients
   against float64 with ``branch_ties``), captured as in phase 12b (its
   launches must reach every kernel of the merged path). The evaluation
   forward recorded as a CUDA graph on the flagship, the projective
   flagship, DPESFM (power-law) and the depth flagship: 3 requests captured
   against two eager runs (bitwise where they agree, else the serving
   tolerance), the warm-up's and the recording's launches a request's, a
   replay's none; a replay after the step's warm-up, recording and a
   replay against an eager forward at the same weights; ms per request
   captured and eager (median of 3) and device memory around the
   recording. Then each single-scene synthetic conf
   (``confs/synth/optim_synth_{gasfm,dpesfm,depth_gasfm,proj_gasfm}.conf``)
   on its own scene from ``create_scene_data``: phase 12b's captured steps
   (launches per step those of an eager ``loss_and_grads``) and the
   recorded forward. The phase's seconds are printed.
15. (after phase 14) Single-scene optimization through the port's CLI,
   ``gasfm_tpu_torch.main.main(["single-scene-optim", ...])`` in this
   process (``CLI_RUNS``): the flagship (``gasfm/optim_euc_gasfm.conf``, full
   width) on the dense scene's sizes from ``dataset.synthetic`` (128 views,
   8,192 points, visibility 0.2), 30 epochs with evaluations at init, after
   epochs 1, 10, 20 and 30 and the final one with bundle adjustment; the
   projective flagship the same way for 10 epochs (``proj_ba``); the four
   single-scene synthetic confs at their own sizes for 20 epochs. Each
   experiment goes to ``chiprun_out/phase15/<run>/``, its output to
   ``chiprun_out/phase15/<run>.log``. Checks: no port kernel launched by any
   step, update or forward after its recording's second call (replays); the
   final ``our_repro`` below the first evaluation's and ``repro_ba <=
   our_repro + 1e-6`` where BA ran; every metric finite; the tree complete
   (results CSV and xlsx, ``final_model.npz``, the predictions' npz, the
   HTML plot for calibrated scenes, one event file, the code snapshot and
   ``exp.conf.json``), then the code snapshot and every file over 1 MiB
   deleted (sizes kept in the record). Printed: the loop's ms per step over
   steps 3..N (median host interval between step calls without an
   evaluation between them) beside phase 12b's captured dense step, and the
   final evaluation's seconds: forward, ``prepare_predictions`` without BA,
   BA, ``compute_errors``.
16. (after phase 15) Multi-scene learning through the port's CLI,
   ``main(["multi-scene-learning", ...])`` in this process (``MSL_RUNS``):
   GASFM (``gasfm/learning_euc_rhaug-15-20_gasfm.conf``, 12 layers, full
   width) on the dense scene's sizes, its lists cut to 3 training, 1
   validation and 1 test scene, 20 epochs (evaluations at init, after epochs
   1, 10 and 20), 4 fine-tuning epochs, no BA, the conf's 8 loader workers;
   DPESFM with outliers (``dpesfm/learning_euc_rhaug-15-20_outliers0.1_
   dpesfm.conf``) in batches of 4 on 64-view scenes; the synthetic conf as
   shipped. Each experiment goes to ``chiprun_out/phase16/<run>/``, its
   output to ``<run>.log``. Checks: every sampled step launched exactly the
   port kernels of its path (``per_step_launches``, ``dpesfm_step_launches``,
   ``dual_unfused_step_launches``, with our_repro's gathers where the fused
   step runs) and made no recording; after training the session holds
   recordings of the fixed evaluation scenes only; the device memory
   allocated after epochs 2..N flat within one subscene's bytes; every
   fixed evaluation scene's forward launched no port kernel from its third
   call on; a batch of four updated with the sum of its samples' gradients
   to float32 rounding; training losses finite; the best validation
   ``our_repro`` no worse than the first evaluation's; the tree complete
   (training, the final and best evaluations, fine-tuning from both weights,
   short optimization). Printed: ms per sampled step, the loader's wait per
   batch, host ms per sample, the subscenes' sizes, the profiler window's
   device ms and busy share, memory per epoch.
13. A ``kernels`` JSON line (all seventeen kernels, each with its per-call
   ``ms`` and its burst ``burst_ms``; launches from the training path that
   runs each: GASFM's merged path for the first eight,
   DPESFM for the segment sum, gather and edge combine, the wide scene's
   unfused path for the attention and the segment max, whose times are the
   wide scene's, the depth flagship for the projection update), the
   nvidia-smi line, and the final ``{"ok": true, "device": ...}`` line.
   The full record goes to ``chiprun_out/chip_smoke.json``.

Tolerances, all float32 with sums in another order than the plain version:
forward kernels |err| <= 1e-5 x scale + 1e-4 x |ref| (the segment max:
bitwise); backward kernels, per
input gradient, |err| <= 1e-4 x scale + 1e-3 x |ref| with scale the
gradient's max |ref| (sums over up to 115k edges), except the layer-0
frontend's d e, whose scale is at least 1 (over two features the
LayerNorm's d e is a near-zero difference of O(1) terms); the model
forwards and the losses |err| <= 1e-3 x scale + 1e-3 x |ref| (nine layers of
flax-form LayerNorms amplify rounding on edges whose features nearly
coincide); the parameter gradients at the first step, per tensor, against
the plain path run in float64 from the same weights: the kernel path's max
|err| at most 4 x the plain float32 path's plus 1e-5 x max |ref| plus 1e-7
x the model's largest gradient, 5e-7 x on the wide scene (some gradients
are sums whose terms cancel exactly, zero in float64, rounding noise in
float32 on both paths), plus the most that the ties move the tensor: the
branches the kernel path took otherwise than float64 (ReLU inputs within
a rounding of 0; the ESFM loss's margin test, the depth loss's L1 sign),
its float64 gradient taken along them against float64's own; losses
after Adam steps rtol 1e-3; parameters after 3 steps, card vs CPU, |err|
<= 1e-6 + 1e-5 x |ref|, for DPESFM plus twice the sum of the three
learning rates (its mean-centering leaves the earlier layers' gradients as
small remainders of cancelling terms, near Adam's eps, and Adam turns their
float32 rounding into steps that differ by a good fraction of lr = 1e-3
between any two float32 runs), with its small-scene step-1 gradients, card
and CPU, held against the CPU's in float64 by the rule above.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-3
GRAD_FACTOR, GRAD_RTOL64, GRAD_EPS64 = 4.0, 1e-5, 1e-7
# The wide scene's cancellation noise (see param_grad_errors): its sums over
# 1280 cameras of 1024-wide tables leave the deterministic kernel path up to
# 2.6e-7 x G from float64 on block 5's LayerNorm biases, while the plain
# float32 path's error on the same tensors changes run to run with its
# atomic sums' order (6e-10 to 1.9e-7 absolute on one of them).
GRAD_EPS64_WIDE = 5e-7
REQUESTS = 3
BURST = 100  # back-to-back calls per burst measurement
TRAIN_STEPS = 3  # timed, after one warm-up step
# Weight seeds of the depth models: the depth loss and every gradient scale
# with 1 / s_pred, the mean predicted depth at init, which sits near 0 at
# seed 0 for both models and costs float32 digits there; at these seeds it
# does not (PERF.md, the depth head's findings). Each phase prints it.
DEPTH_SEEDS = {"gasfm": 2, "dpesfm": 7}
# The depth phases' step-1 rule takes the largest error of this many plain
# float32 runs as its yardstick: the plain path's atomic sums move its error
# run to run, by several times on some LayerNorm biases of the depth flagship,
# enough to fail a rule held to one run (PERF.md). The phase prints the
# spread where it matters most.
DEPTH_PLAIN_RUNS = 3
SEG = "gasfm_tpu/ops/pallas/segment_kernels.py"
# name -> (source in the repo, the TPU kernels' pallas_call it replaces, the
# training path whose launches the kernels line reports; the "wide" path's
# kernels report their times on the wide scene, the others on the dense one)
KERNELS = {
    "fused_dual_attend": ("gasfm_tpu_torch/csrc/fused_dual_attn.cu",
                          "gasfm_tpu/ops/pallas/fused_dual_attn.py:325", "gasfm"),
    "fused_dual_attend_bwd": ("gasfm_tpu_torch/csrc/fused_dual_attn.cu",
                              "gasfm_tpu/ops/pallas/fused_dual_attn.py:575", "gasfm"),
    "fused_frontend": ("gasfm_tpu_torch/csrc/fused_dual_attn.cu",
                       "gasfm_tpu/ops/pallas/fused_dual_attn.py:1023", "gasfm"),
    "fused_frontend_bwd": ("gasfm_tpu_torch/csrc/fused_dual_attn.cu",
                           "gasfm_tpu/ops/pallas/fused_dual_attn.py:1364", "gasfm"),
    "fused_layer_step": ("gasfm_tpu_torch/csrc/fused_layer_step.cu",
                         "gasfm_tpu/ops/pallas/fused_layer_step.py:689", "gasfm"),
    "fused_layer_step_bwd": ("gasfm_tpu_torch/csrc/fused_layer_step.cu",
                             "gasfm_tpu/ops/pallas/fused_layer_step.py:844", "gasfm"),
    "fused_esfm_terms": ("gasfm_tpu_torch/csrc/fused_loss.cu",
                         "gasfm_tpu/ops/pallas/fused_loss.py:253", "gasfm"),
    "fused_esfm_terms_bwd": ("gasfm_tpu_torch/csrc/fused_loss.cu",
                             "gasfm_tpu/ops/pallas/fused_loss.py:296", "gasfm"),
    "segment_sum": ("gasfm_tpu_torch/csrc/segment.cu", f"{SEG}:78, {SEG}:328", "dpesfm"),
    "gather_rows": ("gasfm_tpu_torch/csrc/segment.cu", f"{SEG}:126, {SEG}:432", "dpesfm"),
    "fused_edge_combine": ("gasfm_tpu_torch/csrc/fused_update.cu",
                           "gasfm_tpu/ops/pallas/fused_update.py:97", "dpesfm"),
    "fused_edge_combine_bwd": ("gasfm_tpu_torch/csrc/fused_update.cu",
                               "gasfm_tpu/ops/pallas/fused_update.py:165", "dpesfm"),
    "fused_attend": ("gasfm_tpu_torch/csrc/fused_attn.cu",
                     "gasfm_tpu/ops/pallas/fused_attn.py:386", "wide"),
    "fused_attend_bwd": ("gasfm_tpu_torch/csrc/fused_attn.cu",
                         "gasfm_tpu/ops/pallas/fused_attn.py:524", "wide"),
    "segment_max": ("gasfm_tpu_torch/csrc/segment.cu", f"{SEG}:182, {SEG}:387", "wide"),
    "projection_update": ("gasfm_tpu_torch/csrc/fused_proj_update.cu",
                          "gasfm_tpu/ops/pallas/fused_proj_update.py:291", "gasfm-depth"),
    "projection_update_bwd": ("gasfm_tpu_torch/csrc/fused_proj_update.cu",
                              "gasfm_tpu/ops/pallas/fused_proj_update.py:364", "gasfm-depth"),
}
MERGED_SCENES = ("dense", "powerlaw")  # at most 1024 cameras: the merged GASFM path


class SmokeFailure(RuntimeError):
    pass


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events around each
    call): the per-call time, the host's launch path included."""
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


def burst_ms(fn, reps=BURST, warmup=5) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` back-to-back calls
    between two CUDA events, after a warm-up: the device's time per call
    wherever the host enqueues faster than the device runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want, rtol, atol, floor=1.0):
    """(max |got - want|, within |err| <= atol * scale + rtol * |want|) with
    scale = max(floor, max |want|)."""
    got, want = got.double(), want.double()
    if got.shape != want.shape or not torch.isfinite(got).all():
        return float("inf"), False
    scale = max(floor, float(want.abs().max()))
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol * scale + rtol * want.abs()).all())


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def peak_rss_mib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def same_twice(fn, first):
    """Whether a second call of ``fn`` returns ``first`` bitwise (the
    kernels sum in a fixed order, without atomics)."""
    return all(torch.equal(a, b) for a, b in zip(first, fn()) if a is not None)


def forward_check(results, record, scene_name, name, variant, kernel, plain, outs, io_bytes,
                  flops, main, library=None, exact=False, twice=False):
    """Run ``kernel`` and ``plain`` (each returning a tuple of outputs named
    ``outs``), compare (bitwise with ``exact``; with ``twice`` also a second
    launch against the first, bitwise), time both per call and the kernel
    in a burst (and ``library``, one PyTorch call of the same function,
    where there is one, both ways), and record the variant; ``main``
    variants give the kernels line its numbers."""
    got, want = kernel(), plain()
    worst, ok, ref = 0.0, True, 0.0
    for o, g, w in zip(outs, got, want):
        e, good = max_err(g, w, KERNEL_RTOL, KERNEL_ATOL)
        good = good and (e == 0.0 or not exact)
        worst, ok, ref = max(worst, e), ok and good, max(ref, float(w.abs().max()))
        if not good:
            print(f"  {name}[{variant}] {o}: max err {e:.3e} out of tolerance")
    if twice and not same_twice(kernel, got):
        ok = False
        print(f"  {name}[{variant}]: two launches differ")
    ms, plain_ms, burst = cuda_ms(kernel), cuda_ms(plain), burst_ms(kernel)
    lib_ms = lib_burst = None
    if library is not None:
        lib_ms, lib_burst = cuda_ms(library), burst_ms(library)
    b_ms, b_by = bound_ms(io_bytes, flops)
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms (burst {lib_burst:.4f} ms)"
    tol = "bitwise" if exact else f"tol {KERNEL_ATOL:g} x scale + {KERNEL_RTOL:g} x |ref|"
    print(f"kernel {name}[{variant}] {scene_name}: max_abs_err {worst:.3e} (max |ref| {ref:.4g}) "
          f"({tol}{'; two launches bitwise equal' if twice and ok else ''}) "
          f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms (burst {burst:.4f} ms), plain {plain_ms:.4f} ms"
          f"{lib}, bound {b_ms:.4f} ms ({b_by})")
    record.setdefault("kernel_variants", []).append(dict(
        scene=scene_name, name=name, variant=variant, max_abs_err=worst, max_abs_ref=ref, ok=ok,
        ms=ms, burst_ms=burst, plain_ms=plain_ms, library_ms=lib_ms, library_burst_ms=lib_burst,
        bound_ms=b_ms, bound_by=b_by))
    entry = results.setdefault(name, dict(max_abs_err=0.0, ok=True))
    entry["max_abs_err"] = max(entry["max_abs_err"], worst)
    entry["ok"] = entry["ok"] and ok
    if main:
        entry.update(ms=ms, burst_ms=burst, plain_ms=plain_ms, library_ms=lib_ms,
                     library_burst_ms=lib_burst, bound_ms=b_ms, bound_by=b_by, variant=variant)


def dual_forward_checks(results, record, scene_name, graph, ins, H, main=False):
    """#1 on ``ins`` (xl_p, xl_c, xr_p, xr_c, att_p, att_c) with H heads,
    against its plain version: without residuals (as a request calls it;
    the kernels line's numbers with ``main``) and with them (as under
    autograd: also each side's per-head max and denominator against the
    plain logits'), each launched twice, bitwise."""
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda

    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    D = ins[0].shape[1]
    csr = (graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
    # each input and the CSR read once, each output written once
    io = nbytes(*ins, *csr) + 4 * (n + m) * D
    tag = f"D{D}" + ("" if H == 4 else f"_H{H}")
    forward_check(results, record, scene_name, "fused_dual_attend", tag,
                  lambda: fda.fused_dual_attend(*ins, graph, H),
                  lambda: fda.fused_dual_attend_plain(*ins, graph, H), ("out_pt", "out_cam"),
                  io, 10.0 * E * 2 * D, main, twice=True)

    def kern():
        op, oc, (mp, dp, mc, dc), _ = fda.dual_attend_forward(*ins, graph, H, residuals=True)
        return op, oc, mp.masked_fill(dp == 0, 0.0), dp, mc.masked_fill(dc == 0, 0.0), dc

    def plain():
        return (*fda.fused_dual_attend_plain(*ins, graph, H),
                *attend_residuals_plain(ins[0], ins[2], ins[4], graph, "point", H),
                *attend_residuals_plain(ins[1], ins[3], ins[5], graph, "camera", H))

    forward_check(results, record, scene_name, "fused_dual_attend", f"{tag}_residuals", kern,
                  plain, ("out_pt", "out_cam", "m_pt", "den_pt", "m_cam", "den_cam"),
                  io + 4 * 2 * (n + m) * H, 10.0 * E * 2 * D, False, twice=True)


def kernel_phase(dev, scene_name, graph, model, record):
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls

    gen = torch.Generator(device=dev).manual_seed(1234)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    H = model.equivariant_blocks[0].global_feature_update.n_heads

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    csr = (graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
    results = {}

    def check(*args):
        forward_check(results, record, scene_name, *args)

    # #1 dual core at an interior layer's shapes (D = 32 both sides), without
    # residuals (serving) and with them (under autograd)
    D = 32
    xl_p, xl_c, xr_p, xr_c = rnd(E, D), rnd(E, D), rnd(n, D), rnd(m, D)
    att_p, att_c = rnd(D), rnd(D)
    dual_forward_checks(results, record, scene_name, graph, (xl_p, xl_c, xr_p, xr_c, att_p, att_c),
                        H, main=True)

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
        frontend_fwd_checks(results, record, scene_name, variant, fa, raw, main)

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
              ("e_l", "e_norm_next", "out_pt", "out_cam"), io, flops, False)
        # #5 alone, the kernel the wrapper launches before the dual core: the
        # kernels line's numbers come from the interior form
        prologue_check(results, record, scene_name, variant, graph, sa[:14], raw, main)

    # #7 loss terms, hinge on (the flagship loss) and off.
    P, X = loss_operands(rnd, gen, dev, m, n)
    for variant, hinge, main in (("hinge", True, True), ("no_hinge", False, False)):
        la = (P, X, graph, 1e-4, hinge, 1.0 if hinge else 0.0)
        loss_forward_check(results, record, scene_name, variant, la, main)
    return results


def loss_forward_check(results, record, scene_name, variant, la, main):
    """#7 on ``la`` (P, X, graph, margin, hinge, hinge_w) against its plain
    version, launched twice, bitwise. Its bound: the tables, uv and the two
    id streams read once, three floats written."""
    from gasfm_tpu_torch.ops.kernels import fused_loss as flo

    P, X, graph = la[:3]
    forward_check(results, record, scene_name, "fused_esfm_terms", variant,
                  lambda: (flo.fused_esfm_terms(*la),), lambda: (flo.fused_esfm_terms_plain(*la),),
                  ("terms",), nbytes(P, X, graph.uv, graph.cam_idx, graph.pt_idx) + 12,
                  40.0 * graph.num_edges, main, twice=True)


def frontend_fwd_checks(results, record, scene_name, variant, fa, raw, main):
    """The frontend (#3 + #1) on the 13 operands ``fa`` against its plain
    version, and its prologue (#3) alone, the kernel its wrapper launches
    before the dual core, against the plain prologue, every output; each
    launched twice, bitwise. With ``main`` the prologue's numbers go to the
    kernels line; its bound counts what it moves: e and the parameters read
    once (the LayerNorm's only when used), e_norm (not under raw), xl_p and
    xl_c written once."""
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda

    graph = fa[11]
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    e, De, Dq = fa[0], fa[0].shape[1], fa[3].shape[0]
    csr = (graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
    ln = () if raw else fa[1:3]
    # the whole frontend: inputs read once, e_norm (not under raw), out_pt
    # and out_cam written once
    io = nbytes(e, *ln, *fa[3:11], *csr) + (0 if raw else nbytes(e)) + 4 * (n + m) * Dq
    flops = E * (8 * De + 4 * De * Dq + 20 * Dq)
    forward_check(results, record, scene_name, "fused_frontend", variant,
                  lambda: fda.fused_frontend(*fa, raw_prologue=raw),
                  lambda: fda.fused_frontend_plain(*fa, raw_prologue=raw),
                  ("e_norm", "out_pt", "out_cam"), io, flops, False, twice=True)
    pa = fa[:7]
    io = nbytes(e, *ln, *pa[3:7]) + 4 * E * ((0 if raw else De) + 2 * Dq)
    forward_check(results, record, scene_name, "fused_frontend", f"prologue_{variant}",
                  lambda: fda.frontend_prologue(*pa, raw_prologue=raw),
                  lambda: fda.frontend_prologue_plain(*pa, raw_prologue=raw),
                  ("e_norm", "xl_p", "xl_c"), io, E * (4.0 * De * Dq + 10 * De), main,
                  twice=True)


def frontend_fwd_graph_phase(dev, graphs, record, H=4):
    """#3 in its forms (FRONT_FORMS; at De = 2 the edges' two features kept
    apart) on each of ``graphs``, whole and alone (:func:`frontend_fwd_checks`),
    random parameters."""
    gen = torch.Generator(device=dev).manual_seed(2468)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    results = {}
    for label, graph in graphs.items():
        E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
        for variant, De, Dq, raw in FRONT_FORMS:
            scale = 0.5 if De == 2 else 0.2
            e = separated_pairs(rnd, gen, dev, E) if De == 2 else rnd(E, De)
            fa = (e, 1.0 + rnd(De, scale=0.2), rnd(De, scale=0.1), rnd(Dq, De, scale=scale),
                  rnd(Dq, scale=0.1), rnd(Dq, De, scale=scale), rnd(Dq, scale=0.1), rnd(n, Dq),
                  rnd(m, Dq), rnd(Dq), rnd(Dq), graph, H)
            frontend_fwd_checks(results, record, label, variant, fa, raw, False)
    return results


def prologue_check(results, record, scene_name, variant, graph, pa, raw, main):
    """The layer step's prologue (#5) alone, ``layer_step_prologue`` on the
    14 operands ``pa``, against its plain version, every output, and two
    launches bitwise. Its bound counts what a call moves: en, skip2, res,
    the tables ps and pv and the parameters read once, the two edge
    indices, and e_l, e_norm_next (not under raw), xl_p and xl_c written
    once."""
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls

    E = graph.num_edges
    w, wlp, wlc = pa[3], pa[10], pa[12]
    De, K, Dp, Dc = w.shape[0], w.shape[1], wlp.shape[0], wlc.shape[0]
    io = nbytes(*pa[:8], *(() if raw else pa[8:10]), *pa[10:14], graph.pt_idx, graph.cam_idx) \
        + 4 * E * (De * (1 if raw else 2) + Dp + Dc)
    flops = E * (2.0 * De * (K + Dp + Dc) + 12 * De)
    forward_check(results, record, scene_name, "fused_layer_step", f"prologue_{variant}",
                  lambda: fls.layer_step_prologue(*pa, graph, raw_prologue=raw),
                  lambda: fls.layer_step_prologue_plain(*pa, graph, raw_prologue=raw),
                  ("e_l", "e_norm_next", "xl_p", "xl_c"), io, flops, main, twice=True)


def loss_operands(rnd, gen, dev, m, n):
    """Cameras near [I | (0, 0, 3)], a fifth of them flipped, and points in a
    unit box: depths of both signs, all well away from the margin."""
    P = torch.cat([torch.eye(3, device=dev) + rnd(m, 3, 3, scale=0.1),
                   torch.tensor([[0.0], [0.0], [3.0]], device=dev) + rnd(m, 3, 1, scale=0.1)], dim=2)
    P = (P * torch.where(torch.arange(m, device=dev) % 5 == 0, -1.0, 1.0)[:, None, None])
    X = torch.cat([torch.rand((n, 3), generator=gen, device=dev) * 2 - 1,
                   torch.ones((n, 1), device=dev)], dim=1)
    return P.reshape(m, 12).contiguous(), X


def separated_pairs(rnd, gen, dev, E):
    """(E, 2) edge rows whose two features differ by 0.5 to 2: the flax-form
    LayerNorm over two features loses its digits where they nearly coincide,
    and its backward multiplies that by 1/std."""
    a = rnd(E, 1, scale=2.0)
    gap = torch.rand((E, 1), generator=gen, device=dev) * 1.5 + 0.5
    sign = torch.where(torch.rand((E, 1), generator=gen, device=dev) < 0.5, -1.0, 1.0)
    return torch.cat([a, a - sign * gap], dim=1)


# ---------------------------------------------------------------------------
# phase 3: each backward kernel against autograd of its plain version
# ---------------------------------------------------------------------------


def grads_of(fn, leaves, cots, keep=False):
    """d leaf for each leaf of sum <outputs, cots> (None: unused output),
    and with ``keep`` the arguments of ``autograd.grad`` on the recorded
    graph, to time the backward alone."""
    with torch.enable_grad():
        ls = {k: v.detach().requires_grad_() for k, v in leaves.items()}
        outs = fn(**ls)
        used = [(o, c) for o, c in zip(outs, cots) if c is not None]
        args = ([o for o, _ in used], list(ls.values()), [c for _, c in used])
        grads = torch.autograd.grad(*args, retain_graph=keep)
    return grads, (args if keep else None)


def backward_check(results, record, scene_name, name, variant, kernel, plain, leaves, cots,
                   bwd_kernel, io_bytes, flops, main, floors=None, twice=False):
    """The gradients of ``kernel`` (its backward kernel under autograd)
    against autograd of ``plain``, per input; times ``bwd_kernel`` per call
    and in a burst, and the plain backward. ``floors``: per input, a lower
    bound of the scale its tolerance is taken against (default: its
    gradient's own max |ref|). ``twice``: two launches of ``bwd_kernel``
    must agree bitwise."""
    got, _ = grads_of(kernel, leaves, cots)
    want, args = grads_of(plain, leaves, cots, keep=True)
    worst, ok, errs = 0.0, True, {}
    for leaf, g, w in zip(leaves, got, want):
        e, good = max_err(g, w, BWD_RTOL, BWD_ATOL, floor=(floors or {}).get(leaf, 1e-30))
        errs[leaf] = e
        worst, ok = max(worst, e / max(float(w.abs().max()), 1e-30)), ok and good
        if not good:
            print(f"  {name}[{variant}] d{leaf}: max err {e:.3e} (max |ref| "
                  f"{float(w.abs().max()):.3e}) out of tolerance")
    if twice and not same_twice(bwd_kernel, bwd_kernel()):
        ok = False
        print(f"  {name}[{variant}]: two launches differ")
    ms, burst = cuda_ms(bwd_kernel), burst_ms(bwd_kernel)
    with torch.enable_grad():
        plain_ms = cuda_ms(lambda: torch.autograd.grad(*args, retain_graph=True))
    b_ms, b_by = bound_ms(io_bytes, flops)
    print(f"kernel {name}[{variant}] {scene_name}: max err / max |ref| over input grads "
          f"{worst:.3e} (tol {BWD_ATOL:g} x max|ref| + {BWD_RTOL:g} x |ref|"
          f"{'; two launches bitwise equal' if twice and ok else ''}) "
          f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms (burst {burst:.4f} ms), plain backward "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    record.setdefault("backward_variants", []).append(dict(
        scene=scene_name, name=name, variant=variant, max_abs_err=errs, ok=ok, ms=ms,
        burst_ms=burst, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    entry = results.setdefault(name, dict(max_abs_err=0.0, ok=True))
    entry["max_abs_err"] = max(entry["max_abs_err"], max(errs.values()))
    entry["ok"] = entry["ok"] and ok
    if main:
        entry.update(ms=ms, burst_ms=burst, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     variant=variant)


def backward_phase(dev, scene_name, graph, record):
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls

    gen = torch.Generator(device=dev).manual_seed(4321)
    n, m = graph.num_pts, graph.num_cams
    H = 4

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    results = {}

    def check(*args, **kw):
        backward_check(results, record, scene_name, *args, **kw)

    # #2 dual core at D = 32.
    dual_bwd_check(results, record, scene_name, graph, rnd, 32, H, main=True)

    # #4 frontend at layer 0: De = 2, D = 4, separated feature pairs.
    frontend_bwd_checks(check, rnd, gen, dev, graph, H, FRONT_FORMS[:1], main=True)

    # #6 layer step: interior (skip2 = e0, residual), first-layer form, final raw.
    layer_step_bwd_checks(check, rnd, gen, dev, graph, H, main=True)

    # #8 loss terms, hinge on, in the three equalization modes.
    loss_backward_checks(results, record, scene_name, graph, loss_operands(rnd, gen, dev, m, n),
                         main=True)

    # #4 at De = Dq = 32 (the depth head's widening layer), with the
    # LayerNorm and raw.
    frontend_bwd_checks(check, rnd, gen, dev, graph, H, FRONT_FORMS[1:], main=False)
    return results


def loss_backward_checks(results, record, scene_name, graph, PX, main):
    """#8 with the hinge in its three equalization modes (with ``main``,
    valid_only gives the kernels line its numbers): every input's gradient
    against autograd of the plain version, two launches bitwise. Its bound:
    the tables, uv, both id streams and both CSRs read once, the two table
    gradients written."""
    from gasfm_tpu_torch.ops.kernels import fused_loss as flo

    P, X = PX
    E = graph.num_edges
    coef = torch.full((1,), 1.0 / max(E, 1), device=P.device)
    terms = flo.esfm_terms_forward(P, X, graph, 1e-4, True, 1.0)[0]
    io = nbytes(P, X, graph.uv, graph.cam_idx, graph.pt_idx, graph.pt_ptr, graph.cam_ptr,
                graph.cam_perm, P, X)
    for mode in ("valid_only", "all", "none"):
        count = terms[2:3] if mode == "valid_only" else terms[1:2]
        backward_check(
            results, record, scene_name, "fused_esfm_terms_bwd", mode,
            lambda mode=mode, **a: (flo.fused_esfm_terms(
                a["P"], a["X"], graph, 1e-4, True, 1.0, mode)[0],),
            lambda mode=mode, **a: (flo.fused_esfm_terms_plain(
                a["P"], a["X"], graph, 1e-4, True, 1.0, mode)[0],),
            dict(P=P, X=X), (coef[0],),
            lambda mode=mode, count=count: flo.fused_esfm_terms_bwd(
                P, X, graph, coef, count, 1e-4, True, 1.0, mode),
            io, 80.0 * E, main and mode == "valid_only", twice=True)


def loss_graph_phase(dev, graphs, record):
    """#7 (hinge on and off) and #8 (three equalization modes) against
    their plain versions, each launched twice, bitwise, on the wide scene
    (1,280 cameras of ~37 edges: all short) and on the graphs that stress
    the split #8 walks: the dense scene with empty segments, the dense
    scene plus a camera over all 8,192 points (four parts and a merge
    launch on the camera side) and 4,500 cameras with a point on all (three
    parts and a merge launch on the point side)."""
    gen = torch.Generator(device=dev).manual_seed(7531)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    results = {}
    for label, graph in graphs.items():
        P, X = loss_operands(rnd, gen, dev, graph.num_cams, graph.num_pts)
        with torch.no_grad():
            for variant, hinge in (("hinge", True), ("no_hinge", False)):
                loss_forward_check(results, record, label, variant,
                                   (P, X, graph, 1e-4, hinge, 1.0 if hinge else 0.0), False)
        loss_backward_checks(results, record, label, graph, (P, X), main=False)
    return results


# The frontend's prologue (#3) and backward (#4): (variant, De, Dq, raw) at
# the first layer's widths (their narrow forms, a lane per edge) and at the
# depth head's widening layer's (their tile forms).
FRONT_FORMS = (("De2_layer0", 2, 4, False), ("De32_ln", 32, 32, False),
               ("De32_raw", 32, 32, True))


def frontend_bwd_checks(check, rnd, gen, dev, graph, H, forms, main):
    """The frontend's backward (#4) in each of ``forms`` (FRONT_FORMS;
    at De = 2 the edges' two features kept apart): every input's gradient
    through the frontend and its dual core against autograd of the plain
    version; #4 alone timed (its cotangents of xl_p and xl_c precomputed by
    the dual core's backward) and launched twice, bitwise; the first form's
    numbers go to the kernels line with ``main``. Its bound counts #4's own
    work: e, the cotangents of xl_p, xl_c and e_norm, and the LayerNorm's
    and the linears' weights read once; d e and the six weight gradients
    written once."""
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda

    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    for i, (variant, De, Dq, raw) in enumerate(forms):
        scale = 0.5 if De == 2 else 0.2
        front = dict(e=separated_pairs(rnd, gen, dev, E) if De == 2 else rnd(E, De))
        if not raw:
            front.update(ln_scale=1.0 + rnd(De, scale=0.2), ln_bias=rnd(De, scale=0.1))
        front.update(wlp=rnd(Dq, De, scale=scale), blp=rnd(Dq, scale=0.1),
                     wlc=rnd(Dq, De, scale=scale), blc=rnd(Dq, scale=0.1), xr_p=rnd(n, Dq),
                     xr_c=rnd(m, Dq), att_p=rnd(Dq), att_c=rnd(Dq))
        g_en, g_p, g_c = rnd(E, De), rnd(n, Dq), rnd(m, Dq)

        def fargs(a):
            return (a["e"], a.get("ln_scale"), a.get("ln_bias"), a["wlp"], a["blp"], a["wlc"],
                    a["blc"], a["xr_p"], a["xr_c"], a["att_p"], a["att_c"])

        f = front
        _, xp, xc = fda.frontend_prologue(*fargs(f)[:7], raw_prologue=raw)
        op, oc, res, ins = fda.dual_attend_forward(xp, xc, *fargs(f)[7:], graph, H,
                                                   residuals=True)
        dxp, dxc = fda.fused_dual_attend_bwd(*ins, op, oc, *res, g_p, g_c, graph, H)[:2]
        den = None if raw else g_en
        weights = [f.get("ln_scale"), f.get("ln_bias"), f["wlp"], f["wlc"]]
        check("fused_frontend_bwd", variant,
              lambda raw=raw, fargs=fargs, **a: fda.fused_frontend(
                  *fargs(a), graph, H, raw_prologue=raw),
              lambda raw=raw, fargs=fargs, **a: fda.fused_frontend_plain(
                  *fargs(a), graph, H, raw_prologue=raw),
              front, (g_en, g_p, g_c),
              lambda f=f, dxp=dxp, dxc=dxc, den=den, raw=raw: fda.fused_frontend_bwd(
                  f["e"], f.get("ln_scale"), f.get("ln_bias"), f["wlp"], f["wlc"], dxp, dxc,
                  den, raw_prologue=raw),
              # reads e, the three cotangents, the weights; writes d e and
              # the weights' and biases' gradients
              nbytes(f["e"], den, dxp, dxc, *weights) + nbytes(f["e"], *weights, f["blp"],
                                                              f["blc"]),
              E * (4.0 * De * 2 * Dq + 2 * Dq + (0 if raw else 30 * De)), main and i == 0,
              # Over two features the LayerNorm's output is +-1/sqrt(1 + eps/var)
              # whatever the input: d e is a near-zero difference of O(1) terms,
              # whose rounding scales with those terms (~1), not with |d e|.
              floors={"e": 1.0} if De == 2 and not raw else None, twice=True)


def dual_bwd_check(results, record, scene_name, graph, rnd, D, H, main=False):
    """The dual core's backward (#2) at width D with H heads: every input's
    gradient through the dual core against autograd of its plain version,
    #2 alone timed from the forward's residuals and launched twice,
    bitwise."""
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda

    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    csr = (graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
    dual = dict(xl_p=rnd(E, D), xl_c=rnd(E, D), xr_p=rnd(n, D), xr_c=rnd(m, D),
                att_p=rnd(D), att_c=rnd(D))
    g_p, g_c = rnd(n, D), rnd(m, D)
    op, oc, res, ins = fda.dual_attend_forward(*dual.values(), graph, H, residuals=True)
    backward_check(
        results, record, scene_name, "fused_dual_attend_bwd",
        f"D{D}" + ("" if H == 4 else f"_H{H}"),
        lambda **a: fda.fused_dual_attend(*a.values(), graph, H),
        lambda **a: fda.fused_dual_attend_plain(*a.values(), graph, H),
        dual, (g_p, g_c),
        lambda: fda.fused_dual_attend_bwd(*ins, op, oc, *res, g_p, g_c, graph, H),
        # reads the inputs, outputs, residuals and cotangents and the CSR;
        # writes every input's gradient
        nbytes(*dual.values(), op, oc, *res, g_p, g_c, *csr, *dual.values()),
        20.0 * E * 2 * D, main, twice=True)


def dual_bwd_graph_phase(dev, scenes, record):
    """#1 and #2 on the graphs that stress their split: the dense scene
    without every 50th point and camera 1 (empty segments), the dense scene
    plus a camera over all its points (the hub camera, 8,192 edges), the
    power-law scene plus cameras of exactly L - 1, L, L + 1 and 2L edges and
    a point of 133 (L = 32, the split length; there also at (D, H) = (16,
    4), (32, 1), (8, 8), (12, 6)); and the device time per call of each on
    the dense and hub-camera graphs (profiler windows; #1 with its
    residuals, as under autograd): the hub camera must cost at most 1.5x
    the dense scene."""
    from gasfm_tpu_torch.graph.check_graphs import (degree_graph, graph_with_empty_segments,
                                                    hub_camera_graph)
    from gasfm_tpu_torch.tools.kernel_device_time import (device_ms_per_call, dual_bwd_call,
                                                          dual_fwd_call)

    gen = torch.Generator(device=dev).manual_seed(8080)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def dual_ins(graph, D):
        E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
        return rnd(E, D), rnd(E, D), rnd(n, D), rnd(m, D), rnd(D), rnd(D)

    dense, powerlaw = scenes["dense"].graph, scenes["powerlaw"].graph
    graphs = {"dense_empty": graph_with_empty_segments(dense),
              "hub_camera": hub_camera_graph(dense), "degrees": degree_graph(powerlaw)}
    degs = (graphs["degrees"].cam_ptr[1:] - graphs["degrees"].cam_ptr[:-1])[-4:].tolist()
    print(f"dual core graphs: hub camera {graphs['hub_camera'].num_edges} edges (its camera "
          f"{dense.num_pts}); degrees graph cameras of {degs} edges and a point of "
          f"{int(graphs['degrees'].pt_ptr[-1] - graphs['degrees'].pt_ptr[-2])}")
    results = {}
    with torch.no_grad():
        for label, graph in graphs.items():
            dual_forward_checks(results, record, label, graph, dual_ins(graph, 32), 4)
        for D, H in ((16, 4), (32, 1), (8, 8), (12, 6)):
            dual_forward_checks(results, record, "degrees", graphs["degrees"],
                                dual_ins(graphs["degrees"], D), H)
    for label, graph in graphs.items():
        dual_bwd_check(results, record, label, graph, rnd, 32, 4)
    for D, H in ((16, 4), (32, 1), (8, 8), (12, 6)):
        dual_bwd_check(results, record, "degrees", graphs["degrees"], rnd, D, H)
    for name, call in (("fused_dual_attend", dual_fwd_call),
                       ("fused_dual_attend_bwd", dual_bwd_call)):
        times = {label: device_ms_per_call(call(graph, dev), 20)[0]
                 for label, graph in (("dense", dense), ("hub_camera", graphs["hub_camera"]))}
        ratio = times["hub_camera"] / times["dense"]
        ok = ratio <= 1.5
        print(f"{name} device time per call, D = 32, H = 4: dense {times['dense']:.4f} ms, "
              f"hub camera {times['hub_camera']:.4f} ms, ratio {ratio:.3f} (at most 1.5: "
              f"{'ok' if ok else 'FAIL'})")
        key = "dual_fwd_device_times" if name == "fused_dual_attend" else "dual_bwd_device_times"
        record[key] = dict(times, ratio=ratio, ok=ok)
        results[name]["ok"] = results[name]["ok"] and ok
    return results


def layer_step_bwd_checks(check, rnd, gen, dev, graph, H, main):
    """The layer step's backward (#6) in its interior (skip2 = e0, the
    residual), first-layer (d_in = 2) and raw-prologue forms at D = 32: every
    input's gradient through the layer step and its dual core against
    autograd of the plain version; #6 alone timed (its cotangents of xl_p and
    xl_c precomputed by the dual core's backward) and launched twice,
    bitwise."""
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls

    E, n, m, D = graph.num_edges, graph.num_pts, graph.num_cams, 32
    csr = (graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
    e0 = separated_pairs(rnd, gen, dev, E)
    for variant, d_in, has_res, raw, main_v in (("interior", 32, True, False, main),
                                                ("first_layer", 2, False, False, False),
                                                ("final_raw", 32, True, True, False)):
        K = d_in + 2
        step = dict(en=torch.relu(rnd(E, d_in)), skip2=e0)
        if has_res:
            step["res"] = rnd(E, 32)
        step.update(w=rnd(32, K, scale=0.2), b=rnd(32, scale=0.1), ps=rnd(n, 32), pv=rnd(m, 32),
                    pg=rnd(1, 32))
        if not raw:
            step.update(ln_scale=1.0 + rnd(32, scale=0.2), ln_bias=rnd(32, scale=0.1))
        step.update(wlp=rnd(D, 32, scale=0.2), blp=rnd(D, scale=0.1), wlc=rnd(D, 32, scale=0.2),
                    blc=rnd(D, scale=0.1), xr_p=rnd(n, D), xr_c=rnd(m, D), att_p=rnd(D),
                    att_c=rnd(D))

        def args_of(a, raw=raw, has_res=has_res):
            return (a["en"], a["skip2"], a["res"] if has_res else None, a["w"], a["b"], a["ps"],
                    a["pv"], a["pg"], a.get("ln_scale"), a.get("ln_bias"), a["wlp"], a["blp"],
                    a["wlc"], a["blc"], a["xr_p"], a["xr_c"], a["att_p"], a["att_c"])

        g_el, g_en, g_ps, g_cs = rnd(E, 32), (None if raw else rnd(E, 32)), rnd(n, D), rnd(m, D)
        sa = args_of(step)
        e_l, _, xp, xc = fls.layer_step_prologue(*sa[:14], graph, raw_prologue=raw)
        ops, ocs, ress, inss = fda.dual_attend_forward(xp, xc, *sa[14:], graph, H, residuals=True)
        dxp, dxc = fda.fused_dual_attend_bwd(*inss, ops, ocs, *ress, g_ps, g_cs, graph, H)[:2]
        bwd_in = (sa[0], sa[1], sa[3], e_l, sa[8], sa[9], sa[10], sa[12])

        def step_bwd(bwd_in=bwd_in, dxp=dxp, dxc=dxc, g_el=g_el, g_en=g_en, raw=raw):
            return fls.fused_layer_step_bwd(*bwd_in, graph, dxp, dxc, g_en, g_el,
                                            raw_prologue=raw)

        grads = [t for t in (step["en"], step["skip2"], *sa[3:14]) if t is not None]
        check("fused_layer_step_bwd", variant,
              lambda raw=raw, args_of=args_of, **a: fls.fused_layer_step(
                  *args_of(a), graph, H, raw_prologue=raw),
              lambda raw=raw, args_of=args_of, **a: fls.fused_layer_step_plain(
                  *args_of(a), graph, H, raw_prologue=raw),
              step, (g_el, g_en, g_ps, g_cs), step_bwd,
              # #6 alone, the whole function: reads en, skip2, the saved
              # e_l, W and the next layer's LayerNorm and source linears,
              # the cotangents of xl_p, xl_c, e_norm_next and e_l, the
              # CSR; writes d e_l (once, also d res), d en, d skip2, d ps,
              # d pv and every weight gradient (W, b = pg, LayerNorm, both
              # linears)
              nbytes(*bwd_in, dxp, dxc, g_en, g_el, *csr, e_l, *grads),
              E * (2 * 2 * 2 * D * 32 + 2 * 2 * K * 32 + 40 * 32), main_v, twice=True)


def tile_boundary_phase(dev, record):
    """The layer step's backward (#6) and its prologue (#5) in their three
    forms on :func:`tile_boundary_graph`."""
    from gasfm_tpu_torch.graph.check_graphs import tile_boundary_graph

    graph = tile_boundary_graph(dev)
    gen = torch.Generator(device=dev).manual_seed(9753)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    counts = (graph.pt_ptr[1:] - graph.pt_ptr[:-1]).tolist()
    print(f"tile-boundary graph: {graph.num_cams} views, {graph.num_pts} points, "
          f"{graph.num_edges} edges (E mod 32 = {graph.num_edges % 32}); point 0 has "
          f"{counts[0]} edges, {counts.count(0)} points and "
          f"{int((graph.cam_ptr[1:] == graph.cam_ptr[:-1]).sum())} camera have none")
    results = {}

    def check(*args, **kw):
        backward_check(results, record, "tile_edges", *args, **kw)

    layer_step_bwd_checks(check, rnd, gen, dev, graph, 4, main=False)
    # #5 alone in its three forms (d2 = 2), at the flagship's width and at a
    # narrow one (De = Dp = Dc = 8)
    n, m = graph.num_pts, graph.num_cams
    for De in (32, 8):
        for form, d_in, has_res, raw in (("skip_and_res", De, True, False),
                                         ("first_layer", 2, False, False),
                                         ("raw_prologue", De, True, True)):
            pa = (torch.relu(rnd(graph.num_edges, d_in)), rnd(graph.num_edges, 2),
                  rnd(graph.num_edges, De) if has_res else None, rnd(De, d_in + 2, scale=0.2),
                  rnd(De, scale=0.1), rnd(n, De), rnd(m, De), rnd(1, De),
                  1.0 + rnd(De, scale=0.2), rnd(De, scale=0.1), rnd(De, De, scale=0.2),
                  rnd(De, scale=0.1), rnd(De, De, scale=0.2), rnd(De, scale=0.1))
            prologue_check(results, record, "tile_edges", f"{form}_De{De}", graph, pa, raw, False)
    return results


# ---------------------------------------------------------------------------
# phase 3b: the DPESFM path's kernels against their plain versions
# ---------------------------------------------------------------------------


def segment_sum_check(results, record, scene_name, graph, side, x, main=False):
    """The segment sum of ``x`` over ``side`` against its plain version,
    launched twice, bitwise, and timed beside ``index_add_`` on the same
    data."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    ids, S = sk.side_ids(graph, side)
    ids = ids.long()
    csr = (graph.pt_ptr,) if side == "point" else (graph.cam_ptr, graph.cam_perm)
    E, D = x.shape
    acc = torch.zeros(S, D, device=x.device)
    forward_check(
        results, record, scene_name, "segment_sum", f"{side}_D{D}",
        lambda: (sk.segment_sum(x, graph, side),), lambda: (sk.segment_sum_plain(x, graph, side),),
        ("out",), nbytes(x, *csr) + 4 * S * D, float(E * D), main, twice=True,
        library=lambda: acc.index_add_(0, ids, x))


def dpesfm_kernel_phase(dev, scene_name, graph, record):
    """segment_sum on both sides at D = 2 (the uv stream of DPESFM's first
    layer), 4 and 32 (the unfused GASFM layer's camera denominators and
    numerators) and 256 (every later DPESFM stream), twice, bitwise, and
    gather_rows at D = 2 and 256, against their plain versions and the one
    PyTorch call that computes the same function (``index_add_``,
    ``index_select``); the edge combine at D = 256 and its backward at D =
    2, 4, 32 and 256 (against autograd of the plain forward, twice
    bitwise)."""
    from gasfm_tpu_torch.ops.kernels import fused_update as fu
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(2468)
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    results = {}
    ids = {"point": graph.pt_idx.long(), "camera": graph.cam_idx.long()}
    for D in (256, 32, 4, 2):
        for side, S in (("point", n), ("camera", m)):
            main = D == 256 and side == "point"
            segment_sum_check(results, record, scene_name, graph, side, rnd(E, D), main)
            if D not in (256, 2):
                continue
            table = rnd(S, D)
            forward_check(
                results, record, scene_name, "gather_rows", f"{side}_D{D}",
                lambda t=table, side=side: (sk.gather_rows(t, graph, side),),
                lambda t=table, side=side: (sk.gather_rows_plain(t, graph, side),), ("out",),
                nbytes(table, ids[side].int()) + 4 * E * D, 0.0, main, exact=True, twice=True,
                library=lambda t=table, side=side: torch.index_select(t, 0, ids[side]))
            if main:
                gather_host_parts(table, graph, side, scene_name, record)

    D = 256
    pe, ps, pv, pg = rnd(E, D), rnd(n, D), rnd(m, D), rnd(1, D)
    forward_check(results, record, scene_name, "fused_edge_combine", "D256",
                  lambda: (fu.fused_edge_combine(pe, ps, pv, pg, graph),),
                  lambda: (fu.fused_edge_combine_plain(pe, ps, pv, pg, graph),), ("out",),
                  nbytes(pe, ps, pv, pg, graph.pt_idx, graph.cam_idx) + 4 * E * D,
                  4.0 * E * D, True)

    for D in (256, 32, 4, 2):
        edge_combine_bwd_check(results, record, scene_name, graph, rnd(E, D), main=D == 256)
    return results


# the wide scene's #12 at D = 256 when its point pass gave each point a warp
# (PERF.md's findings: kernel_device_time, NVIDIA H100 80GB HBM3, 700 W)
EDGE_COMBINE_BWD_WIDE_PARENT_MS = 0.6327


def edge_combine_bwd_check(results, record, scene_name, graph, g, main=False):
    """#12 from the cotangent g against autograd of the plain edge combine,
    each gradient within tolerance, d pe bitwise (g / 4), two launches
    bitwise equal; timed per call and in a burst beside the plain
    backward."""
    from gasfm_tpu_torch.ops.kernels import fused_update as fu

    E, D = g.shape
    n, m = graph.num_pts, graph.num_cams
    got = fu.fused_edge_combine_bwd(g, graph)
    with torch.enable_grad():
        leaves = [torch.zeros(shape, device=g.device, requires_grad=True)
                  for shape in ((E, D), (n, D), (m, D), (1, D))]
        args = ([fu.fused_edge_combine_plain(*leaves, graph)], leaves, [g])
        want = torch.autograd.grad(*args, retain_graph=True)
    worst, ok, errs = 0.0, True, {}
    for leaf, a, b in zip(("pe", "ps", "pv", "pg"), got, want):
        e, good = max_err(a, b.reshape(a.shape), BWD_RTOL, BWD_ATOL, floor=1e-30)
        good = good and (leaf != "pe" or e == 0.0)
        errs[leaf] = e
        worst, ok = max(worst, e / max(float(b.abs().max()), 1e-30)), ok and good
        if not good:
            print(f"  fused_edge_combine_bwd[D{D}] {scene_name} d{leaf}: max err {e:.3e} out of "
                  "tolerance")
    if not same_twice(lambda: fu.fused_edge_combine_bwd(g, graph), got):
        ok = False
        print(f"  fused_edge_combine_bwd[D{D}] {scene_name}: two launches differ")
    ms = cuda_ms(lambda: fu.fused_edge_combine_bwd(g, graph))
    burst = burst_ms(lambda: fu.fused_edge_combine_bwd(g, graph))
    with torch.enable_grad():
        plain_ms = cuda_ms(lambda: torch.autograd.grad(*args, retain_graph=True))
    # reads g and the CSR once; writes d pe, d ps, d pv, d pg
    b_ms, b_by = bound_ms(nbytes(g, graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
                          + 4 * (E + n + m + 1) * D, 3.0 * E * D)
    print(f"kernel fused_edge_combine_bwd[D{D}] {scene_name}: max err / max |ref| over the four "
          f"gradients {worst:.3e} (tol {BWD_ATOL:g} x max|ref| + {BWD_RTOL:g} x |ref|; d pe "
          f"bitwise; two launches bitwise equal) {'ok' if ok else 'FAIL'}; {ms:.4f} ms (burst "
          f"{burst:.4f} ms), plain backward {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    record.setdefault("backward_variants", []).append(dict(
        scene=scene_name, name="fused_edge_combine_bwd", variant=f"D{D}", max_abs_err=errs,
        ok=ok, ms=ms, burst_ms=burst, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    entry = results.setdefault("fused_edge_combine_bwd", dict(max_abs_err=0.0, ok=True))
    entry["max_abs_err"] = max(entry["max_abs_err"], max(errs.values()))
    entry["ok"] = entry["ok"] and ok
    if main:
        entry.update(ms=ms, burst_ms=burst, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                     bound_by=b_by, variant=f"D{D}")


def edge_combine_bwd_graph_phase(dev, scenes, wide, record):
    """#12 at D = 2, 4, 32 and 256 on the wide scene and on graphs that
    stress its point walk (the wide scene plus a point in all 1280 views and
    points of 63, 64, 65 and 128 edges; 4,500 cameras with a point on all,
    cut into three parts; the power-law scene plus cameras of 31-64 edges
    and a point of 133; the dense scene with empty segments), each against
    autograd of its plain version, twice bitwise; and its device time per
    call at D = 256 on the wide scene (beside the parent's) and on the
    hub-point graph: at most 1.5x the wide scene's."""
    from gasfm_tpu_torch.graph.check_graphs import (degree_graph, graph_with_empty_segments,
                                                    hub_parts_graph, hub_point_graph)
    from gasfm_tpu_torch.ops.kernels import fused_update as fu
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk
    from gasfm_tpu_torch.tools.kernel_device_time import device_ms_per_call

    gen = torch.Generator(device=dev).manual_seed(4680)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    graphs = {"wide": wide, "hub_point": hub_point_graph(wide, sk.SUM_ROWS),
              "hub_parts": hub_parts_graph(dev), "degrees": degree_graph(scenes["powerlaw"].graph),
              "dense_empty": graph_with_empty_segments(scenes["dense"].graph)}
    results = {}
    for label, graph in graphs.items():
        for D in (256, 32, 4, 2):
            edge_combine_bwd_check(results, record, label, graph, rnd(graph.num_edges, D))
    times = {}
    for label in ("wide", "hub_point"):
        g = rnd(graphs[label].num_edges, 256)
        times[label] = device_ms_per_call(
            lambda g=g, gr=graphs[label]: fu.fused_edge_combine_bwd(g, gr), 20)[0]
    ratio = times["hub_point"] / times["wide"]
    ok = ratio <= 1.5
    print(f"fused_edge_combine_bwd device time per call, D = 256: wide {times['wide']:.4f} ms "
          f"(parent {EDGE_COMBINE_BWD_WIDE_PARENT_MS} ms, PERF.md), hub point "
          f"{times['hub_point']:.4f} ms, ratio {ratio:.3f} (at most 1.5: "
          f"{'ok' if ok else 'FAIL'})")
    record["edge_combine_bwd_device_times"] = dict(times, ratio=ratio, ok=ok,
                                                   wide_parent=EDGE_COMBINE_BWD_WIDE_PARENT_MS)
    results["fused_edge_combine_bwd"]["ok"] = results["fused_edge_combine_bwd"]["ok"] and ok
    return results


def segment_sum_graph_phase(dev, scenes, wide, record):
    """The segment sum on both sides at D = 2, 4, 32 and 256 on the wide
    scene and on graphs that stress its split (the dense scene plus a camera
    over all its points, a hub of four parts; the power-law scene plus
    cameras of 31, 32, 33 and 64 edges and a point of 133; the wide scene
    plus a point in every view and points of L - 1, L, L + 1 and 2L edges, L
    = 64 the longest short segment; 4,500 cameras and a point on all of
    them, a point-side hub of three parts), against its plain version,
    twice, bitwise; and its device time per call on each of the first three
    graphs against its base scene at D = 32 and 256: at most 1.5x."""
    from gasfm_tpu_torch.graph.check_graphs import (degree_graph, hub_camera_graph,
                                                    hub_parts_graph, hub_point_graph)
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk
    from gasfm_tpu_torch.tools.kernel_device_time import device_ms_per_call

    gen = torch.Generator(device=dev).manual_seed(3579)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    base = {"dense": scenes["dense"].graph, "powerlaw": scenes["powerlaw"].graph, "wide": wide}
    hubs = {"hub_camera": ("dense", hub_camera_graph(base["dense"])),
            "degrees": ("powerlaw", degree_graph(base["powerlaw"])),
            "hub_point": ("wide", hub_point_graph(base["wide"], sk.SUM_ROWS))}  # 63-128 edges
    results = {}
    checked = [("wide", wide)] + [(k, g) for k, (_, g) in hubs.items()]
    for label, graph in checked + [("hub_parts", hub_parts_graph(dev))]:
        for D in (256, 32, 4, 2):
            for side in ("point", "camera"):
                segment_sum_check(results, record, label, graph, side, rnd(graph.num_edges, D))
    times, ok = {}, True
    for label, (base_label, graph) in hubs.items():
        for D in (256, 32):
            for side in ("point", "camera"):
                t = {}
                for name, gr in ((label, graph), (base_label, base[base_label])):
                    x = rnd(gr.num_edges, D)
                    t[name] = device_ms_per_call(lambda x=x, gr=gr: sk.segment_sum(x, gr, side),
                                                 20)[0]
                ratio = t[label] / t[base_label]
                ok = ok and ratio <= 1.5
                times[f"{label}_{side}_D{D}"] = dict(t, ratio=ratio)
                print(f"segment_sum device time per call, {side} side, D = {D}: {label} "
                      f"{t[label]:.4f} ms, {base_label} {t[base_label]:.4f} ms, ratio "
                      f"{ratio:.3f} (at most 1.5: {'ok' if ratio <= 1.5 else 'FAIL'})")
    record["segment_sum_device_times"] = dict(times, ok=ok)
    results["segment_sum"]["ok"] = results["segment_sum"]["ok"] and ok
    return results


def gather_host_parts(table, graph, side, scene_name, record, reps=200):
    """Where the host's microseconds of one gather call go: the wrapper's
    steps (``segment_kernels.gather_rows_forward``) timed apart on the host
    clock, each over ``reps`` calls (fewer launches than CUDA's queue
    holds, so the host never waits on the device), against the whole call."""
    from gasfm_tpu_torch.ops.kernels import build as kb
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    dev = table.device
    ids, S = sk.side_ids(graph, side)
    E, D = ids.shape[0], table.shape[1]
    entry = sk._entry("gasfm_gather_rows")
    out = torch.empty((E, D), dtype=torch.float32, device=dev)

    def checks():
        sk.side_ids(graph, side)
        sk._check_width("table", table, S)
        kb.aligned(kb.cuda_f32("table", table))
        kb.cuda_i32("ids", ids)

    parts = {
        "checks": checks,
        "alloc": lambda: table.new_empty((E, D)),
        "stream": lambda: kb.stream(table.device),
        "launch": lambda: entry(table.data_ptr(), D, ids.data_ptr(), E, out.data_ptr(),
                                kb.stream(table.device)),
        "whole_call": lambda: sk.gather_rows_forward(table, graph, side),
    }
    us = {}
    for k, fn in parts.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us[k] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    print(f"gather_rows[{side}_D{D}] {scene_name}: host microseconds per call, by part: "
          + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
    record.setdefault("gather_host_us", {})[scene_name] = us


# ---------------------------------------------------------------------------
# phase 3c: the unfused path's kernels against their plain versions
# ---------------------------------------------------------------------------


def hub_graph(graph, seed=13):
    """``graph`` plus a point seen by every camera (a hub) and points of
    exactly L - 1, L, L + 1 and 2L edges, L the point-side attention's split
    length (``ATTEND_CHUNK``; ``check_graphs.hub_point_graph``)."""
    from gasfm_tpu_torch.graph.check_graphs import hub_point_graph
    from gasfm_tpu_torch.ops.kernels.fused_attn import ATTEND_CHUNK

    return hub_point_graph(graph, ATTEND_CHUNK, seed)


def attend_residuals_plain(xl, xr, att, graph, side, heads):
    """Each segment's per-head softmax max and denominator (the residuals
    the attention forward writes under autograd), from the plain logits:
    (m, den), each (S, H), m set to 0 where den is 0 (an empty segment,
    whose max the kernel leaves at -inf)."""
    from gasfm_tpu_torch.ops.gatv2 import NEGATIVE_SLOPE, leaky_relu
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    ids, S = sk.side_ids(graph, side)
    ids = ids.long()
    z = leaky_relu(xl + xr[ids], NEGATIVE_SLOPE) * att
    logits = z.reshape(z.shape[0], heads, -1).sum(-1)
    m = sk.segment_max_plain(logits, graph, side)
    den = torch.zeros((S, heads), device=xl.device).index_add_(0, ids, torch.exp(logits - m[ids]))
    return m.masked_fill(den == 0, 0.0), den


def attention_checks(results, record, scene_name, graph, label, rnd, main_point,
                     shapes=((32, 4),)):
    """The single-direction attention on both sides of ``graph`` at each
    (D, H) of ``shapes`` (D = 32, H = 4: an interior layer's aggregation):
    the forward (twice, bitwise), its residuals (max and denominator)
    against the plain logits', the backward (twice, bitwise) against
    autograd of the plain forward."""
    from gasfm_tpu_torch.ops.kernels import fused_attn as fat

    E = graph.num_edges
    csr = {"point": (graph.pt_ptr,), "camera": (graph.cam_ptr, graph.cam_perm)}
    for (D, H), side in ((shape, side) for shape in shapes for side in ("point", "camera")):
        S = graph.num_pts if side == "point" else graph.num_cams
        main = main_point and side == "point" and (D, H) == (32, 4)
        ins = dict(xl=rnd(E, D), xr=rnd(S, D), att=rnd(D))

        def kern(side=side, H=H, **a):
            return (fat.fused_attend(a["xl"], a["xr"], a["att"], graph, side, H),)

        def plain(side=side, H=H, **a):
            return (fat.fused_attend_plain(a["xl"], a["xr"], a["att"], graph, side, H),)

        def kern_res(side=side, H=H):
            _, (m, den), _ = fat.attend_forward(*ins.values(), graph, side, H, residuals=True)
            return m.masked_fill(den == 0, 0.0), den

        variant = f"{side}_D{D}{'' if H == 4 else f'_H{H}'}{label}"
        forward_check(results, record, scene_name, "fused_attend", variant,
                      lambda: kern(**ins), lambda: plain(**ins), ("out",),
                      nbytes(*ins.values(), *csr[side]) + 4 * S * D, 10.0 * E * D, main,
                      twice=True)
        forward_check(results, record, scene_name, "fused_attend", f"{variant}_residuals",
                      kern_res, lambda side=side, H=H: attend_residuals_plain(
                          *ins.values(), graph, side, H), ("m", "den"),
                      nbytes(*ins.values(), *csr[side]) + 4 * (S * D + 2 * S * H),
                      10.0 * E * D, False, twice=True)
        g = rnd(S, D)
        out, res, saved = fat.attend_forward(*ins.values(), graph, side, H, residuals=True)
        backward_check(
            results, record, scene_name, "fused_attend_bwd", variant, kern, plain, ins,
            (g,), lambda side=side, H=H, out=out, res=res, saved=saved, g=g: fat.fused_attend_bwd(
                *saved, out, *res, g, graph, side, H),
            # reads: xl, xr, att, the output, residuals and cotangent, the
            # CSR; writes d xl, d xr, d att
            nbytes(*ins.values(), out, *res, g, *csr[side], *ins.values()), 20.0 * E * D, main,
            twice=True)


def attention_device_times(graphs, rnd, record):
    """#13 (the forward with residuals) and #14 (the backward from them) on
    the point side at D = 32, H = 4: device time per call from profiler
    windows (``tools/kernel_device_time``). The hub graph adds a point of
    every camera's edge to the wide one; with at most ATTEND_CHUNK edges
    per warp it must cost less than 1.5x the wide graph."""
    from gasfm_tpu_torch.ops.kernels import fused_attn as fat
    from gasfm_tpu_torch.tools.kernel_device_time import device_ms_per_call

    times = {}
    for label, graph in graphs.items():
        H, D, S = 4, 32, graph.num_pts
        xl, xr, att, g = rnd(graph.num_edges, D), rnd(S, D), rnd(D), rnd(S, D)
        out, res, saved = fat.attend_forward(xl, xr, att, graph, "point", H, residuals=True)
        fwd = device_ms_per_call(
            lambda: fat.attend_forward(xl, xr, att, graph, "point", H, residuals=True), 20)
        bwd = device_ms_per_call(
            lambda: fat.fused_attend_bwd(*saved, out, *res, g, graph, "point", H), 20)
        times[label] = dict(fused_attend=fwd[0], fused_attend_bwd=bwd[0],
                            fused_attend_launches=fwd[1], fused_attend_bwd_launches=bwd[1])
    ratios = {k: times["hub"][k] / times["wide"][k] for k in ("fused_attend", "fused_attend_bwd")}
    ok = all(r < 1.5 for r in ratios.values())
    print(f"attention device time per call, point side, D = 32, H = 4: wide graph #13 "
          f"{times['wide']['fused_attend']:.4f} ms, #14 {times['wide']['fused_attend_bwd']:.4f} "
          f"ms; hub graph #13 {times['hub']['fused_attend']:.4f} ms, #14 "
          f"{times['hub']['fused_attend_bwd']:.4f} ms; hub / wide {ratios['fused_attend']:.3f}, "
          f"{ratios['fused_attend_bwd']:.3f} (below 1.5: {'ok' if ok else 'FAIL'}); launches "
          f"per call {times['wide']['fused_attend_launches']}, "
          f"{times['wide']['fused_attend_bwd_launches']}")
    record["attention_device_times"] = dict(times, ratios=ratios, ok=ok)
    return ok


def unfused_kernel_phase(dev, scene_name, graph, record):
    """The kernels the unfused path adds: the single-direction attention
    forward and backward on both sides (:func:`attention_checks`), on the
    wide scene also on a copy with empty segments and on
    :func:`hub_graph`, with #13's and #14's device times on the wide and
    hub graphs; the segment max (:func:`segment_max_checks`) on the scene's
    graph and on a copy with empty segments. The main variants are the main
    path's: the attention on the point side, the max on the camera side at
    D = 4."""
    from gasfm_tpu_torch.graph.check_graphs import graph_with_empty_segments

    gen = torch.Generator(device=dev).manual_seed(1357)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    results = {}
    attention_checks(results, record, scene_name, graph, "", rnd, True)
    if scene_name == "wide":
        hub = hub_graph(graph)
        counts = (hub.pt_ptr[1:] - hub.pt_ptr[:-1])[-5:].tolist()
        print(f"hub graph: the wide scene plus points of {counts} edges "
              f"({hub.num_edges} edges)")
        attention_checks(results, record, scene_name, graph_with_empty_segments(graph), "_empty",
                         rnd, False)
        attention_checks(results, record, scene_name, hub, "_hub", rnd, False)
        # the other head widths the kernels take: C = 4 (D < 32), 32, 1 and 2
        # (features of several heads on one lane), and D not a multiple of 4
        attention_checks(results, record, scene_name, hub, "_hub", rnd, False,
                         shapes=((16, 4), (32, 1), (8, 8), (12, 6), (6, 3)))
        if not attention_device_times({"wide": graph, "hub": hub}, rnd, record):
            results["fused_attend"]["ok"] = False

    segment_max_checks(results, record, scene_name, graph, "", rnd, main=True)
    segment_max_checks(results, record, scene_name, graph_with_empty_segments(graph), "_empty",
                       rnd, main=False)
    return results


def segment_max_checks(results, record, scene_name, graph, label, rnd, main):
    """The segment max on both sides of ``graph`` at D = 1, 4 (the logits
    of 4 heads: the camera composite's) and 8, with a caller's neutral
    (-7.5: empty segments must give it), bitwise against its plain version,
    launched twice, bitwise, and timed beside ``scatter_reduce_`` (amax) on
    the same data; with ``main`` the camera side at D = 4 gives the kernels
    line its numbers. Its bound: the rows, the CSR (and permutation) read
    once, the maxima written once."""
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    neutral = -7.5
    ids = {"point": graph.pt_idx.long(), "camera": graph.cam_idx.long()}
    csr = {"point": (graph.pt_ptr,), "camera": (graph.cam_ptr, graph.cam_perm)}
    for D in (1, 4, 8):
        for side, S in (("point", graph.num_pts), ("camera", graph.num_cams)):
            x = rnd(graph.num_edges, D)
            acc = torch.full((S, D), neutral, device=x.device)
            idx = ids[side][:, None].expand(-1, D).contiguous()
            forward_check(
                results, record, scene_name, "segment_max", f"{side}_D{D}{label}",
                lambda x=x, side=side: (sk.segment_max(x, graph, side, neutral),),
                lambda x=x, side=side: (sk.segment_max_plain(x, graph, side, neutral),),
                ("out",), nbytes(x, *csr[side]) + 4 * S * D, float(x.numel()),
                main=main and D == 4 and side == "camera", exact=True, twice=True,
                library=lambda acc=acc, idx=idx, x=x: acc.scatter_reduce_(
                    0, idx, x, reduce="amax", include_self=False))


def segment_max_graph_phase(dev, scenes, record):
    """The segment max (:func:`segment_max_checks`) on the graphs that
    stress the sum's split it walks: the dense scene plus a camera over all
    8,192 points (four parts of 2,048 rows and the merge launch), 4,500
    cameras with a point on all (three parts, the merge on the point side)
    and the power-law scene plus cameras of 31-64 edges and a point of 133
    (long segments of one part)."""
    from gasfm_tpu_torch.graph.check_graphs import (degree_graph, hub_camera_graph,
                                                    hub_parts_graph)

    gen = torch.Generator(device=dev).manual_seed(8642)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    results = {}
    graphs = {"hub_camera": hub_camera_graph(scenes["dense"].graph),
              "hub_parts": hub_parts_graph(dev), "degrees": degree_graph(scenes["powerlaw"].graph)}
    for label, graph in graphs.items():
        segment_max_checks(results, record, label, graph, "", rnd, main=False)
    return results


# ---------------------------------------------------------------------------
# phase 3d: the projection update (the depth path's layer L-2)
# ---------------------------------------------------------------------------


def projection_update_phase(dev, scene_name, graph, record, main=True):
    """The standalone projection update at the depth flagship's layer L-2
    shapes (en (E, 32), W (32, 32 + d2)): with skip2 (the 2-wide init skip)
    and the residual, the main variant (with ``main``); with neither; at d2
    = 0 with the residual. Forward against the plain version, backward
    (every input's gradient) against autograd of the plain version, its two
    launches bitwise equal."""
    from gasfm_tpu_torch.ops.kernels import fused_proj_update as fpu

    gen = torch.Generator(device=dev).manual_seed(8642)
    E, n, m, De = graph.num_edges, graph.num_pts, graph.num_cams, 32

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    results = {}
    idx = (graph.pt_idx, graph.cam_idx)
    csr = (graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
    for variant, d2, has_res, main_v in (("skip2_res", 2, True, main), ("bare", 0, False, False),
                                         ("res_only", 0, True, False)):
        K = De + d2
        ins = dict(en=torch.relu(rnd(E, De)))
        if d2:
            ins["skip2"] = rnd(E, d2)
        if has_res:
            ins["res"] = rnd(E, De)
        ins.update(w=rnd(De, K, scale=0.2), b=rnd(De, scale=0.1), ps=rnd(n, De), pv=rnd(m, De),
                   pg=rnd(1, De))

        def kern(**a):
            return (fpu.projection_update(a["en"], a.get("skip2"), a.get("res"), a["w"], a["b"],
                                          a["ps"], a["pv"], a["pg"], graph),)

        def plain(**a):
            return (fpu.projection_update_plain(a["en"], a.get("skip2"), a.get("res"), a["w"],
                                                a["b"], a["ps"], a["pv"], a["pg"], graph),)

        # reads every input and the edge ids once, writes e
        forward_check(results, record, scene_name, "projection_update", variant,
                      lambda: kern(**ins), lambda: plain(**ins), ("e",),
                      nbytes(*ins.values(), *idx) + 4 * E * De,
                      float(E * (2 * K * De + 6 * De)), main_v, twice=True)
        g = rnd(E, De)
        backward_check(
            results, record, scene_name, "projection_update_bwd", variant, kern, plain, ins, (g,),
            lambda g=g, ins=ins: fpu.projection_update_bwd(g, ins["en"], ins.get("skip2"),
                                                           ins["w"], graph),
            # reads g, en, skip2, W and the CSR; writes d en, d skip2, d W,
            # d b (= d pg), d ps, d pv (d res is g, no kernel work)
            nbytes(g, ins["en"], ins.get("skip2"), ins["w"], *csr, ins["en"], ins.get("skip2"),
                   ins["w"], ins["b"], ins["ps"], ins["pv"]),
            float(E * (4 * K * De + 3 * De)), main_v, twice=True)
    return results


def frontend_bwd_graph_phase(dev, graphs, record):
    """#4 in its three forms (FRONT_FORMS) on each of ``graphs``, the
    graphs that stress its tiles and spans."""
    gen = torch.Generator(device=dev).manual_seed(1357)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    results = {}
    for label, graph in graphs.items():
        def check(*args, label=label, **kw):
            backward_check(results, record, label, *args, **kw)

        frontend_bwd_checks(check, rnd, gen, dev, graph, 4, FRONT_FORMS, main=False)
    return results


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


# our_repro's per-edge gathers (cameras, points, Ns_inv) in each fused_step
REPRO_LAUNCHES = {"gather_rows": 3}


def per_step_launches(L, backward):
    """Exact kernel launches of one forward + loss (and, with ``backward``,
    of its backward) through an L-layer GASFM model."""
    fwd = {"fused_frontend": 1, "fused_layer_step": L, "fused_dual_attend": L + 1,
           "fused_esfm_terms": 1}
    bwd = {"fused_esfm_terms_bwd": 1, "fused_layer_step_bwd": L, "fused_frontend_bwd": 1,
           "fused_dual_attend_bwd": L + 1}
    return {**fwd, **{k: v if backward else 0 for k, v in bwd.items()}}


def unfused_step_launches(L, backward):
    """Exact kernel launches of one forward + loss (and, with ``backward``,
    of its backward) through an L-layer GASFM model on a scene of more than
    1024 cameras, where every layer and the final aggregation run unfused:
    per aggregation the single-direction attention (points) and the camera
    composite (the gathers of the queries and of the max, the segment max,
    one segment sum of [p * xl | p]); per layer one edge combine; the loss
    terms once. Backward: each attention's and edge combine's, and per
    aggregation the sum's backward (a gather) and the query gather's (a
    sum); the max is taken of detached logits and has none."""
    A = L + 1
    fwd = {"fused_attend": A, "segment_max": A, "gather_rows": 2 * A, "segment_sum": A,
           "fused_edge_combine": L, "fused_esfm_terms": 1}
    bwd = {"fused_attend_bwd": A, "gather_rows": A, "segment_sum": A,
           "fused_edge_combine_bwd": L, "fused_esfm_terms_bwd": 1}
    out = dict(fwd)
    for k, v in bwd.items():
        out[k] = out.get(k, 0) + (v if backward else 0)
    return out


def dpesfm_step_launches(model, backward):
    """Exact kernel launches of one forward + loss (and, with ``backward``,
    of its backward) through a SetOfSetNet: per layer two segment sums (its
    point and camera means) and one edge combine, two more sums in the
    final update, the loss terms once. Backward: each edge combine's, and a
    gather for every sum whose input carries gradient — all but the first
    layer's, whose input is the raw uv."""
    layers = sum(len(blk.layers) for blk in model.equivariant_blocks)
    # with the depth head: no final update, and the depth loss has no kernel
    final, loss = (0, 0) if model.depth_head_enabled else (2, 1)
    fwd = {"segment_sum": 2 * layers + final, "fused_edge_combine": layers,
           "fused_esfm_terms": loss}
    bwd = {"fused_edge_combine_bwd": layers, "gather_rows": 2 * (layers - 1) + final,
           "fused_esfm_terms_bwd": loss}
    return {**fwd, **{k: v if backward else 0 for k, v in bwd.items()}}


def depth_step_launches(L, backward):
    """Exact kernel launches of one forward + depth loss (and, with
    ``backward``, of its backward) through an L-layer GASFM with the depth
    head (L >= 3, the depth width not n_feat_proj), merged path: the
    frontend at layer 0 and at the unfused, widening layer L-1; the layer
    step at layers 1 to L-2, each with its dual core, as the frontends;
    layer L-2's own update through the projection update; layer L-1's
    through the edge combine. No final aggregation and no loss kernel."""
    fwd = {"fused_frontend": 2, "fused_layer_step": L - 2, "fused_dual_attend": L,
           "projection_update": 1, "fused_edge_combine": 1}
    bwd = {"fused_frontend_bwd": 2, "fused_layer_step_bwd": L - 2, "fused_dual_attend_bwd": L,
           "projection_update_bwd": 1, "fused_edge_combine_bwd": 1}
    return {**fwd, **{k: v if backward else 0 for k, v in bwd.items()}}


def slice_phase(dev, session, scenes, counters, record, per_request, label):
    """Serving: REQUESTS forward + loss requests per scene, counters zeroed
    just before and read just after, exact launches checked; then each
    output against the plain path on the card."""
    from gasfm_tpu_torch.ops.kernels.fused_attn import fused_attend
    from gasfm_tpu_torch.ops.kernels.fused_dual_attn import fused_dual_attend

    outputs = {}
    for fn in counters.values():
        fn.launches = 0
    fused_dual_attend.residual_launches = fused_attend.residual_launches = 0
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
        want = {k: REQUESTS * per_request.get(k, 0) for k in counters}
        if delta != want:
            raise SmokeFailure(f"{label} {name}: launches {delta}, expected {want}")
        E = scene.graph.num_edges
        ms = statistics.median(times)
        print(f"{label} {name}: {scene.graph.num_cams} views, {scene.graph.num_pts} points, "
              f"{E} edges; {REQUESTS} requests, ms/request {[round(t, 3) for t in times]} "
              f"(median {ms:.3f} ms, {E / ms * 1e3:.4g} edges/s); loss {float(loss):.6f}; "
              f"launches {({k: v for k, v in delta.items() if v})}")
        record.setdefault(label, {})[name] = dict(
            views=scene.graph.num_cams, points=scene.graph.num_pts, edges=E,
            ms_per_request=times, median_ms=ms, edges_per_s=E / ms * 1e3,
            loss=float(loss), launches=delta)
    launches = {k: fn.launches for k, fn in counters.items()}  # read just after the path
    if fused_dual_attend.residual_launches or fused_attend.residual_launches:
        raise SmokeFailure(f"serving wrote softmax residuals in "
                           f"{fused_dual_attend.residual_launches} dual and "
                           f"{fused_attend.residual_launches} attention launches")
    print(f"{label}: no backward launch and no residual write under no_grad")

    for name, scene in scenes.items():
        pred, loss = outputs[name]
        ref = session.forward(scene, plain=True)
        ref_loss = session.loss(ref, scene, plain=True)
        g = scene.graph
        shapes = {"Ps_norm": (g.num_cams, 3, 4), "pts3D": (4, g.num_pts),
                  "depths": (g.num_edges,)}
        if {k: tuple(v.shape) for k, v in pred.items()} != {k: shapes[k] for k in pred}:
            raise SmokeFailure(f"{name}: output shapes {[tuple(v.shape) for v in pred.values()]}")
        if "depths" in pred:
            print(f"{label} {name}: mean predicted depth s_pred {float(pred['depths'].mean()):.6g} "
                  f"(the depth loss scales with 1 / s_pred)")
        errs = {}
        for key, got, want in ((*((k, pred[k], ref[k]) for k in pred),
                                ("loss", loss.reshape(1), ref_loss.reshape(1)))):
            err, ok = max_err(got, want, SLICE_RTOL, SLICE_ATOL)
            errs[key] = err
            if not ok:
                raise SmokeFailure(f"{label} {name}: {key} kernel vs plain max err {err:.3e} "
                                   f"out of tolerance")
        print(f"{label} {name}: kernel vs plain path on the card, max abs err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol {SLICE_ATOL:g} x scale + {SLICE_RTOL:g} x |ref|) ok")
        record[label][name]["kernel_vs_plain_max_abs_err"] = errs
    return launches


# ---------------------------------------------------------------------------
# phase 5: training, the main path
# ---------------------------------------------------------------------------


def float64_scene(scene):
    """The scene with its float arrays in float64, for a float64 run of the
    plain path."""
    import dataclasses

    return dataclasses.replace(
        scene, graph=dataclasses.replace(scene.graph, uv=scene.graph.uv.double()),
        Ns=scene.Ns.double(), Ns_inv=scene.Ns_inv.double(),
        gt_depths=None if scene.gt_depths is None else scene.gt_depths.double())


def param_grad_errors(names, got, plain, ref, eps64=GRAD_EPS64, ties=None, more_plain=()):
    """Per parameter: (name, kernel path's max |err|, plain path's max |err|,
    max |ref|, the plain path's smallest max |err|, ok), both float32 paths
    against the float64 plain path (the plain path's errors over ``plain``
    and ``more_plain``, further runs of it, whose atomic sums differ run to
    run). ok:
    the kernel path's error is at most GRAD_FACTOR x the plain path's, plus
    GRAD_RTOL64 x the tensor's max |ref|, plus ``eps64`` (GRAD_EPS64) x the
    largest gradient of the model (G). Why the last: some gradients are sums over
    many edges whose terms cancel exactly (a segment's softmax-logit
    gradients sum to 0, so d xr of a point whose edges all take the same
    LeakyReLU branch is 0, and with it the gradients of the query adapter
    and lin_r); in float32 both paths return rounding noise of order
    eps x the terms there, which no bound relative to the (zero) true value
    can take. ``ties``: per parameter, the most that the ties move it
    (:func:`branch_ties`), added to the bound."""
    G = max(float(r.abs().max()) for r in ref)
    out = []
    for k, (name, g, r) in enumerate(zip(names, got, ref)):
        ek = float((g.double() - r).abs().max())
        eps = [float((p[k].double() - r).abs().max()) for p in (plain, *more_plain)]
        ep = max(eps)
        scale = float(r.abs().max())
        ok = bool(torch.isfinite(g).all()) and \
            ek <= GRAD_FACTOR * ep + GRAD_RTOL64 * scale + eps64 * G + (ties[k] if ties else 0.0)
        out.append((name, ek, ep, scale, min(eps), ok))
    return out, G


def depth_ties(ref_session, scene64, pred32, pred64):
    """The depth loss's L1 ties between a float32 path and the float64 run:
    the edges where the sign of d / s_pred - d_gt / s_gt differs between
    ``pred32`` and ``pred64``, each a flip of that edge's term in the step-1
    gradient. Returns (their number, the smallest |d / s_pred - d_gt / s_gt|
    of the float64 run, per parameter the most the flips can move its
    gradient: max |the float64 gradient of (2 / E) x the sum of |d / s_pred -
    d_gt / s_gt| over the flipped edges|)."""
    gt = scene64.gt_depths
    s_gt = gt.mean()
    s_gt = torch.where(s_gt == 0, torch.ones_like(s_gt), s_gt)

    def residual(d):
        d = d.double()
        return d / d.mean() - gt / s_gt

    r64 = residual(pred64["depths"])
    flips = torch.sign(residual(pred32["depths"])) != torch.sign(r64)
    n = int(flips.sum())
    params = ref_session.params
    if n == 0:
        return 0, float(r64.abs().min()), [0.0] * len(params)
    with torch.enable_grad():
        r = residual(ref_session.model(scene64.graph, plain=True)["depths"])
        moved = torch.autograd.grad((2.0 / r.shape[0]) * r[flips].abs().sum(), params,
                                    allow_unused=True)
    return n, float(r64.abs().min()), [0.0 if g is None else float(g.abs().max()) for g in moved]


class ActivationBranches:
    """Which way each ReLU and each GATv2 LeakyReLU of a forward went,
    element by element: every ``torch.relu`` call (``nn.ReLU``'s too) and
    every call of ``ops.gatv2.leaky_relu`` (the attention's PyTorch parts) is
    keyed by its innermost call site in the port and its occurrence there.
    Under :meth:`watch`: ``"record"`` keeps the kernel path's branches (z >
    0 for a ReLU, z >= 0 for the LeakyReLU); ``"compare"``, on the float64
    run, keeps per key the elements whose branch differs (``flips``: their
    mask and the largest |float64 input| among them); ``"force"`` makes the
    keys with flips take the kernel path's branches. The activations that
    the CUDA kernels apply inside themselves are not seen."""

    def __init__(self):
        self.signs, self.flips = {}, {}

    @contextlib.contextmanager
    def watch(self, mode):
        from gasfm_tpu_torch.ops import gatv2

        relu, leaky, count = torch.relu, gatv2.leaky_relu, collections.Counter()

        def watched(x, branch, act, other):
            f = sys._getframe(2)
            while f is not None and "gasfm_tpu_torch" not in f.f_code.co_filename:
                f = f.f_back
            site = "?" if f is None else \
                f"{f.f_code.co_filename.rsplit('gasfm_tpu_torch', 1)[-1]}:{f.f_lineno}"
            count[site] += 1
            key = (site, count[site])
            if mode == "record":
                self.signs[key] = branch(x.detach())
            elif mode == "compare":
                kept = self.signs.get(key)
                if kept is not None and kept.shape == x.shape:
                    d = branch(x.detach()) != kept
                    if bool(d.any()):
                        self.flips[key] = (d, float(x.detach()[d].abs().max()))
            elif key in self.flips:
                return torch.where(self.signs[key], x, other(x))
            return act()

        def watched_relu(x, *args, **kw):
            return watched(x, lambda z: z > 0, lambda: relu(x, *args, **kw), torch.zeros_like)

        def watched_leaky(z, negative_slope=gatv2.NEGATIVE_SLOPE):
            return watched(z, lambda v: v >= 0, lambda: leaky(z, negative_slope),
                           lambda v: negative_slope * v)

        torch.relu, gatv2.leaky_relu = watched_relu, watched_leaky
        try:
            yield
        finally:
            torch.relu, gatv2.leaky_relu = relu, leaky


def branch_ties(ref_session, scene64, pred32, pred64, grads64, acts):
    """The branches that a float32 path (``pred32``; its activations in
    ``acts``, an :class:`ActivationBranches` compared with the float64
    run's) took otherwise than the float64 run (``pred64``, ``grads64``):
    ReLUs and LeakyReLUs whose input sits within a rounding of 0, and the
    loss's own ties. Each is a jump in the step-1
    gradient that no rounding bound takes. The ESFM loss's tie is its
    margin test (an edge's term swaps between its reprojection error and
    its hinge, and under the valid-only equalization the count that
    divides every normalized cotangent moves); the depth loss's, its L1
    (:func:`depth_ties`). Returns (a summary, per parameter the most the
    ties move its gradient): with activation or margin flips, max |the float64
    gradient taken along the float32 path's branches minus the float64
    run's|, plus the L1 ties' part. The ESFM loss is restated here with the
    margin test as an argument (``fused_esfm_terms_plain``'s arithmetic),
    and held to the loss itself on the same forward."""
    from gasfm_tpu_torch.losses import ESFMLoss
    from gasfm_tpu_torch.ops.kernels.fused_loss import EqualizeGrads

    loss, graph, params = ref_session.loss_func, scene64.graph, ref_session.params
    n_act = sum(int(d.sum()) for d, _ in acts.flips.values())
    info = dict(act_flips=n_act, act_sites=sorted({k[0] for k in acts.flips}),
                act_far=max((v for _, v in acts.flips.values()), default=0.0))
    if isinstance(loss, ESFMLoss):
        cam, pt = graph.cam_idx.long(), graph.pt_idx.long()
        margin, E = loss.infinity_pts_margin, graph.num_edges

        def projections(pred):
            P = pred["Ps_norm"].reshape(graph.num_cams, 12)[cam].reshape(-1, 3, 4)
            return (P * pred["pts3D"].T[pt][:, None, :]).sum(-1)  # (E, 3)

        def passes(depth):
            return depth >= margin if loss.hinge_loss else depth.abs() >= margin

        def masked_loss(proj, pos):
            if loss.eq_mode != "none":
                count = pos.sum().to(proj.dtype) if loss.eq_mode == "valid_only" else \
                    torch.tensor(float(E), dtype=proj.dtype, device=proj.device)
                proj = EqualizeGrads.apply(proj, pos, 1.0 / count.clamp_min(1.0),
                                           loss.eq_mode == "valid_only")
            depth = proj[:, 2]
            r = proj[:, :2] / torch.where(pos, depth, torch.ones_like(depth))[:, None] - graph.uv
            sq = (r * r).sum(1)
            nz = sq > 0
            rnorm = torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))),
                                torch.zeros_like(sq))
            term = torch.where(pos, rnorm, (margin - depth) * loss.hinge_loss_weight)
            return term.sum() / max(E, 1)

        with torch.no_grad():
            depth64 = projections(pred64)[:, 2]
            pos32 = passes(projections(pred32)[:, 2])
        n_loss = int((pos32 != passes(depth64)).sum())
        info.update(loss_tie="margin", loss_flips=n_loss,
                    loss_nearest=float((depth64 - margin).abs().min()))
        l1 = [0.0] * len(params)
    else:
        n_l1, nearest, l1 = depth_ties(ref_session, scene64, pred32, pred64)
        info.update(loss_tie="L1", loss_flips=n_l1, loss_nearest=nearest)
        n_loss = 0  # the L1 ties' part is l1
    jump = [0.0] * len(params)
    if n_act or n_loss:
        with torch.enable_grad(), acts.watch("force"):
            pred = ref_session.model(graph, plain=True)
            if isinstance(loss, ESFMLoss):
                proj = projections(pred)
                own = float(masked_loss(proj, passes(proj[:, 2].detach())).detach())
                want = float(loss(pred, scene64, True).detach())
                if abs(own - want) > 1e-12 * max(abs(want), 1.0):
                    raise SmokeFailure(f"branch_ties: the restated ESFM loss {own!r} is not "
                                       f"the loss's {want!r}")
                taken = masked_loss(proj, pos32)
            else:
                taken = loss(pred, scene64, plain=True)
            along = torch.autograd.grad(taken, params, allow_unused=True)
        jump = [0.0 if g is None else float((g - r).abs().max()) for g, r in zip(along, grads64)]
    ties = [a + b for a, b in zip(jump, l1)]
    info["most"] = max(ties)
    return info, ties


def make_loss(loss_kw):
    """The loss of a conf's keyword arguments: the depth loss's or ESFM's."""
    from gasfm_tpu_torch.losses import DirectDepthLoss, ESFMLoss

    return DirectDepthLoss(**loss_kw) if "cost_fcn" in loss_kw else ESFMLoss(**loss_kw)


def train_phase(dev, scenes, counters, record, model, loss_kw, optim, per_step, label,
                eps64=GRAD_EPS64, plain_runs=1):
    """Training, a main path: ``fused_step`` 1 + TRAIN_STEPS steps per scene
    of ``model`` with its conf's loss (``loss_kw``) and optimizer, counters
    zeroed just before and read just after, exact launches checked (the
    warm-up step takes no our_repro, each timed step one); step-1 gradients
    against float64, losses against a plain twin. A depth-head model steps
    through ``loss_and_grads`` + ``update`` (no our_repro), as the JAX
    package's loop trains it. The step-1 rule also allows, per tensor, for
    the branches that the kernel path took otherwise than float64: ReLU
    ties and the loss's (:func:`branch_ties`). ``plain_runs``: the plain float32 runs whose
    largest error is the rule's yardstick."""
    import copy

    from gasfm_tpu_torch.ops.kernels.fused_attn import fused_attend
    from gasfm_tpu_torch.ops.kernels.fused_dual_attn import fused_dual_attend
    from gasfm_tpu_torch.train.loop import TrainingSession

    twin = copy.deepcopy(model)
    ref64 = copy.deepcopy(model).double()
    session = TrainingSession(model, make_loss(loss_kw), device=dev, optim=optim, capture=False)
    plain = TrainingSession(twin, make_loss(loss_kw), device=dev, optim=optim, capture=False)
    ref = TrainingSession(ref64, make_loss(loss_kw), device=dev, optim=optim, capture=False)
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    depth = model.depth_head_enabled
    repro = {} if depth else REPRO_LAUNCHES

    def step(sess, scene, plain_path=False):
        """One timed step: (loss, our_repro, grad_norm), or (loss,
        grad_norm) for a depth model."""
        if not depth:
            return sess.fused_step(scene, plain=plain_path)
        loss_, _, grads_ = sess.loss_and_grads(scene, plain=plain_path)
        return loss_, sess.update(grads_)
    for fn in counters.values():
        fn.launches = 0
    fused_dual_attend.residual_launches = fused_attend.residual_launches = 0
    for name, scene in scenes.items():
        before = {k: fn.launches for k, fn in counters.items()}
        E = scene.graph.num_edges
        # Step 1 (warm-up, not timed): the kernel path's and the plain twin's
        # gradients from the same weights, each against the plain path in
        # float64 (first scene: from the same weights too), then both update.
        p_loss, _, p_grads = plain.loss_and_grads(scene, plain=True)
        acts = ActivationBranches()
        with acts.watch("record") if ref is not None else contextlib.nullcontext():
            loss, pred, grads = session.loss_and_grads(scene)
        if depth:
            print(f"{label} {name}: step 1 mean predicted depth s_pred "
                  f"{float(pred['depths'].mean()):.6g} (the loss and every gradient scale with "
                  f"1 / s_pred)")
        if ref is not None:
            scene64 = float64_scene(scene)
            with acts.watch("compare"):
                r_loss, r_pred, r_grads = ref.loss_and_grads(scene64, plain=True)
            tie, ties = branch_ties(ref, scene64, pred, r_pred, r_grads, acts)
            del acts
            n_flip = tie["act_flips"] + tie["loss_flips"]
            tie_note = (f"; ties: {tie['act_flips']} (Leaky)ReLU inputs change branch against "
                        f"float64 (at {tie['act_sites']}, |float64 input| at most "
                        f"{tie['act_far']:.3e}), "
                        f"{tie['loss_flips']} edges take the other branch of the loss's "
                        f"{tie['loss_tie']} (nearest tie {tie['loss_nearest']:.3e}); their most "
                        f"on any gradient {tie['most']:.3e}, added to the bound")
            record.setdefault(label, {})[f"{name}_ties"] = tie
            more = [plain.loss_and_grads(scene, plain=True)[2] for _ in range(plain_runs - 1)]
            errs, G = param_grad_errors(names, grads, p_grads, r_grads, eps64, ties, more)
            del more
            if n_flip:  # where the ties move a gradient most
                k = max(range(len(ties)), key=ties.__getitem__)
                tie_note += (f" (on {errs[k][0]}: kernel path {errs[k][1]:.3e}, plain path "
                             f"{errs[k][2]:.3e})")
            bad = [t for t in errs if not t[-1]]
            wk = max(errs, key=lambda t: t[1])
            wp = max(errs, key=lambda t: t[2])
            if plain_runs > 1:  # where one plain run's error would bound it most tightly
                tight = max(errs, key=lambda t: t[1] / (GRAD_FACTOR * t[4] + GRAD_RTOL64 * t[3]
                                                        + eps64 * G))
                tie_note += (f"; the plain path's error moves run to run, {tight[4]:.3e} to "
                             f"{tight[2]:.3e} over {plain_runs} runs on {tight[0]} (kernel path "
                             f"{tight[1]:.3e})")
            print(f"{label} {name}: step 1 parameter gradients ({len(errs)} tensors, largest "
                  f"|grad| G = {G:.4g}) against the plain path in float64: max |err| kernel path "
                  f"{wk[1]:.3e} ({wk[0]}, its max |ref| {wk[3]:.3e}), plain float32 path "
                  f"{wp[2]:.3e} ({wp[0]}, its max |ref| {wp[3]:.3e}"
                  f"{f'; the largest of {plain_runs} runs' if plain_runs > 1 else ''}); loss float64 "
                  f"{float(r_loss)!r}, kernel path {float(loss)!r}, plain path {float(p_loss)!r} "
                  f"(tol kernel err <= {GRAD_FACTOR:g} x plain err + {GRAD_RTOL64:g} x max|ref| "
                  f"+ {eps64:g} x G){tie_note} {'ok' if not bad else 'FAIL'}")
            if bad:
                raise SmokeFailure(f"{label} {name}: parameter gradients out of tolerance: "
                                   f"{[t[:4] for t in bad[:8]]}")
            record.setdefault(label, {})[name] = dict(
                step1_grad_vs_float64=[t[:4] for t in errs], step1_grad_G=G)
            del r_grads, r_pred, ref, ref64  # the float64 run covers the first scene only
            ref = None
        session.update(grads)
        plain.update(p_grads)
        losses, plain_losses = [float(loss)], [float(p_loss)]
        del grads, p_grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times, steps = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(session, scene)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            steps.append([float(v) for v in out])
        peak = torch.cuda.max_memory_allocated(dev)
        delta = {k: fn.launches - before[k] for k, fn in counters.items()}
        want = {k: (1 + TRAIN_STEPS) * per_step.get(k, 0) + TRAIN_STEPS * repro.get(k, 0)
                for k in counters}
        if delta != want:
            raise SmokeFailure(f"{label} {name}: training launches {delta}, expected {want}")
        for _ in range(TRAIN_STEPS):
            plain_losses.append(float(step(plain, scene, plain_path=True)[0]))
        losses += [st[0] for st in steps]
        for k, (a, b) in enumerate(zip(losses, plain_losses)):
            if not all(map(math.isfinite, steps[-1])) or abs(a - b) > SLICE_RTOL * abs(b):
                raise SmokeFailure(f"{label} {name}: step {k + 1} loss {a!r} vs plain path {b!r}")
        ms = statistics.median(times)
        step_calls = {k: per_step.get(k, 0) + repro.get(k, 0) for k in counters}
        print(f"{label} {name}: {scene.graph.num_cams} views, {scene.graph.num_pts} points, {E} "
              f"edges; ms/step {[round(t, 3) for t in times]} (median {ms:.3f} ms, "
              f"{E / ms * 1e3:.4g} edges/s); "
              f"({'loss, grad_norm' if depth else 'loss, our_repro, grad_norm'}) per step {steps}; "
              f"peak device memory {peak / 2**20:.1f} MiB; launches over {1 + TRAIN_STEPS} "
              f"steps {({k: v for k, v in delta.items() if v})}, per timed step "
              f"{({k: v for k, v in step_calls.items() if v})} ({sum(step_calls.values())} "
              f"calls of the port's kernels)")
        print(f"{label} {name}: loss per step, kernel path {losses} vs plain path "
              f"{plain_losses} (rtol {SLICE_RTOL:g}) ok")
        record.setdefault(label, {}).setdefault(name, {}).update(
            edges=E, ms_per_step=times, median_ms=ms, edges_per_s=E / ms * 1e3,
            loss_repro_gradnorm=steps, peak_bytes=peak, launches=delta,
            losses=losses, plain_losses=plain_losses)
    launches = {k: fn.launches for k, fn in counters.items()}  # read just after the main path
    if fused_dual_attend.residual_launches != launches["fused_dual_attend"] or \
            fused_attend.residual_launches != launches["fused_attend"]:
        raise SmokeFailure("training: an attention launch under autograd wrote no residuals")
    return launches


def small_scene_check(dev, session, record, loss_kw, optim, label, adam_bound=False):
    """The kernel path on the card against the plain path on the CPU, same
    weights, on a small scene: the forward, then 3 training steps each."""
    import copy

    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.losses import ESFMLoss
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
            raise SmokeFailure(f"{label} small scene: {key} card vs CPU max err {err:.3e}")
    print(f"{label} small scene (8 views, 600 points): kernel path on the card vs plain path on "
          "the CPU, max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " ok")
    record[f"{label}_small_scene_card_vs_cpu_max_abs_err"] = errs

    # Three training steps each from the same weights; the parameters after
    # them within 1e-6 + 1e-5 x |ref| of the CPU's. With ``adam_bound``
    # (DPESFM) that bound grows by twice the sum of the three learning
    # rates, the most two Adam runs can part: DPESFM's mean-centering leaves
    # the earlier layers' gradients as small remainders of cancelling terms,
    # near Adam's eps, and Adam turns their float32 rounding into steps that
    # differ by a good fraction of lr (two float32 runs of the plain path on
    # one CPU part by ~2e-5 after 3 steps at lr 1e-3). Its first-step
    # parameter gradients are then held, card and CPU, against the CPU's in
    # float64 under the main path's rule (param_grad_errors).
    card = TrainingSession(copy.deepcopy(session.model), ESFMLoss(**loss_kw), device=dev,
                           optim=optim, capture=False)
    cpu = TrainingSession(copy.deepcopy(session.model).cpu(), ESFMLoss(**loss_kw),
                          device="cpu", optim=optim)
    slack = 0.0
    if adam_bound:
        r64 = TrainingSession(copy.deepcopy(session.model).cpu().double(), ESFMLoss(**loss_kw),
                              device="cpu", optim=optim)
        names = [k for k, p in card.model.named_parameters() if p.requires_grad]
        errs, G = param_grad_errors(
            names, [g.cpu() for g in card.loss_and_grads(scene)[2]],
            cpu.loss_and_grads(want_scene)[2],
            r64.loss_and_grads(float64_scene(want_scene), plain=True)[2])
        bad = [t for t in errs if not t[-1]]
        if bad:
            raise SmokeFailure(f"{label} small scene: step-1 gradients out of tolerance: "
                               f"{[t[:4] for t in bad[:8]]}")
        wk = max(errs, key=lambda t: t[1])
        print(f"{label} small scene: step-1 parameter gradients against the CPU in float64: "
              f"max |err| card {wk[1]:.3e} ({wk[0]}), CPU float32 {max(t[2] for t in errs):.3e} "
              f"(tol as the main path's) ok")
        slack = 2.0 * sum(card.lr_at(k) for k in range(3))
    for step in range(3):
        got = [float(v) for v in card.fused_step(scene)]
        want = [float(v) for v in cpu.fused_step(want_scene)]
        for key, a, b in zip(("loss", "our_repro", "grad_norm"), got, want):
            if not math.isfinite(a) or abs(a - b) > SLICE_RTOL * abs(b):
                raise SmokeFailure(f"{label} small scene step {step + 1}: {key} card {a!r} vs "
                                   f"CPU {b!r}")
    worst, worst_name = 0.0, ""
    for (name, a), b in zip(card.model.named_parameters(), cpu.model.parameters()):
        a, b = a.detach().cpu().double(), b.detach().double()
        err = float((a - b).abs().max())
        if not bool(((a - b).abs() <= 1e-6 + 1e-5 * b.abs() + slack).all()):
            raise SmokeFailure(f"{label} small scene: {name} after 3 steps, card vs CPU max err "
                               f"{err:.3e}")
        if err > worst:
            worst, worst_name = err, name
    print(f"{label} small scene: 3 training steps, card vs CPU: loss, our_repro, grad_norm per "
          f"step within rtol {SLICE_RTOL:g}; parameters after 3 steps max abs err {worst:.3e} "
          f"({worst_name}) (tol 1e-6 + 1e-5 x |ref| + {slack:g}) ok")
    record[f"{label}_small_scene_train_param_max_abs_err"] = worst


# ---------------------------------------------------------------------------
# phase 12b: the training step recorded as CUDA graphs
# ---------------------------------------------------------------------------

CAPTURE_REPLAYS = 200  # further replays after the compared steps
CAPTURE_CHECK_EVERY = 50  # replays between checks of the step's loss against a forward


def session_programs(session):
    """{(kind, id(scene graph), or None for the session's own update
    inputs): the recording} of every recording ``session`` holds."""
    out = {(kind, id(c.ref())): prog for c in session._cache.calls.values()
           for kind, prog in c.programs.items()}
    out.update({(kind, None): prog for kind, prog in session._own.programs.items()})
    return out


@contextlib.contextmanager
def operand_copies():
    """Counts, by operand name, the kernel operands that the wrappers'
    validation copied while the block runs: ``cuda_f32`` / ``cuda_i32``
    made one contiguous, or ``aligned`` cloned one to 16 bytes. Inside a
    recording each such copy is a launch of every replay."""
    from gasfm_tpu_torch.ops.kernels import build as kb

    copies = collections.Counter()
    saved = {name: getattr(kb, name) for name in ("cuda_f32", "cuda_i32", "aligned")}

    def counting(name, fn):
        def validate(*args, **kw):
            out = fn(*args, **kw)
            given = args[0] if name == "aligned" else args[1]
            if out is not given:
                copies[name if name == "aligned" else args[0]] += 1
            return out
        return validate

    for name, fn in saved.items():
        setattr(kb, name, counting(name, fn))
    try:
        yield copies
    finally:
        for name, fn in saved.items():
            setattr(kb, name, fn)


def captured_phase(dev, label, model, loss_kw, optim, scene, counters, per_step, record,
                   adam_bound=False):
    """The training step of ``model`` recorded as CUDA graphs (the session's
    default on the card) against the eager step from the same weights: two
    eager sessions and a captured one take 1 + TRAIN_STEPS steps side by
    side; loss, our_repro, grad norm and every parameter after every step,
    captured against eager bitwise where the two eager runs agree bitwise,
    else within the small-scene rule's tolerances (rtol SLICE_RTOL for the
    three values; parameters 1e-6 + 1e-5 x |ref|, plus twice the learning
    rates so far with ``adam_bound``). Launches: the warm-up step and the
    recording count one step each, a replay none. Then CAPTURE_REPLAYS
    replays: each kept loss unchanged after the next replay, the loss finite,
    and every CAPTURE_CHECK_EVERY replays against the loss of a forward
    taken just before (the loss's ticket counter starts each replay at 0).
    Then a checkpoint, 2 steps (A), a restore in place, the same 2 steps (B):
    A equals B as the steps above compared, on the same graphs. Prints ms per
    step captured and eager (median of 3), launches and peak memory."""
    import copy
    import tempfile

    from gasfm_tpu_torch.tools.profile_forward import train_step
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.train.state import restore_checkpoint, save_checkpoint

    depth = model.depth_head_enabled
    names = ("loss", "grad_norm") if depth else ("loss", "our_repro", "grad_norm")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sessions = {k: TrainingSession(copy.deepcopy(model), make_loss(loss_kw), device=dev,
                                   optim=optim, capture=k == "captured")
                for k in ("eager", "eager2", "captured")}
    cap, eager = sessions["captured"], sessions["eager"]
    per_call = {k: per_step.get(k, 0) + (0 if depth else REPRO_LAUNCHES.get(k, 0))
                for k in counters}

    def counted(fn):
        before = {k: c.launches for k, c in counters.items()}
        out = fn()
        return out, {k: c.launches - before[k] for k, c in counters.items()}

    def compare(got, want, got_params, want_params, lr_steps, bitwise):
        """(max |err| of the values, max |err| of the parameters, ok); the
        parameters' slack with ``adam_bound`` is twice the learning rates of
        the batches ``lr_steps`` that the two runs took apart."""
        slack = 2.0 * sum(cap.lr_at(k) for k in lr_steps) if adam_bound else 0.0
        got_params = [t.detach() for t in got_params]
        want_params = [t.detach() for t in want_params]
        v_err = max(abs(a - b) for a, b in zip(got, want))
        ok = all(a == b if bitwise else math.isfinite(a) and abs(a - b) <= SLICE_RTOL * abs(b)
                 for a, b in zip(got, want))
        p_err = 0.0
        for a, b in zip(got_params, want_params):
            if bitwise:
                same = torch.equal(a, b)
                ok &= same
                if not same:
                    p_err = max(p_err, float((a - b).abs().max()))
                continue
            d = (a - b).abs()
            p_err = max(p_err, float(d.max()))
            ok &= bool((d <= 1e-6 + 1e-5 * b.abs() + slack).all())
        return v_err, p_err, ok

    # 1 + TRAIN_STEPS steps side by side
    steps, launches, eager_bitwise = [], [], True
    for k in range(1 + TRAIN_STEPS):
        e = [float(v) for v in train_step(eager, scene)]
        e2 = [float(v) for v in train_step(sessions["eager2"], scene)]
        with operand_copies() as copies:
            c, delta = counted(lambda: train_step(cap, scene))
        if k == 1:  # the recording
            recorded_copies = dict(copies)
        c = [float(v) for v in c]
        launches.append(sum(delta.values()))
        want = per_call if k < 2 else {}  # the warm-up and the recording; replays count none
        if delta != {n: want.get(n, 0) for n in counters}:
            raise SmokeFailure(f"captured {label}: step {k + 1} launches {delta}, expected {want}")
        same = e == e2 and all(torch.equal(a, b) for a, b in
                               zip(eager.params, sessions["eager2"].params))
        eager_bitwise &= same
        # the parameters after this step, captured against eager, under both rules
        v_err, p_err, ok_tol = compare(c, e, cap.params, eager.params, range(k + 1), False)
        exact = c == e and all(torch.equal(a, b) for a, b in zip(cap.params, eager.params))
        steps.append((c, e, e2, exact, ok_tol, v_err, p_err))
    rule = "bitwise" if eager_bitwise else "tolerance"
    bad = [k + 1 for k, st in enumerate(steps) if not (st[3] if eager_bitwise else st[4])]
    if bad:
        raise SmokeFailure(f"captured {label}: steps {bad} captured vs eager out of the {rule} "
                           f"rule: {[st[:3] + st[5:] for st in steps]}")
    def graphs():  # the step's recordings (the forward's, taken below, apart)
        return {k: p.graph for k, p in session_programs(cap).items() if k[0] != "forward"}

    recorded = graphs()
    if {k[0] for k in recorded} != ({"loss_and_grads", "update"} if depth else {"fused_step"}):
        raise SmokeFailure(f"captured {label}: recorded programs {list(session_programs(cap))}")
    print(f"captured {label}: {1 + TRAIN_STEPS} steps captured (warm-up, recording, replays) "
          f"against eager from the same weights: two eager runs "
          + ("agree bitwise, and so do captured and eager" if eager_bitwise else
             "differ, so captured vs eager is held to the tolerances") +
          f" ({rule}); per step ({', '.join(names)}) captured / eager: "
          f"{[(st[0], st[1]) for st in steps]}; max |err| values "
          f"{max(st[5] for st in steps):.3e}, parameters {max(st[6] for st in steps):.3e}; "
          f"port kernel launches per captured call {launches} (a step's {sum(per_call.values())} "
          f"at the warm-up and the recording, none at a replay); operands the wrappers' "
          f"validation copied in the recording {recorded_copies or 'none'} ok")

    # ms per step, median of 3 each
    def timed(sess):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(sess, scene)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    ms = {k: statistics.median(timed(sessions[k])[0] for _ in range(3))
          for k in ("captured", "eager")}

    # further replays: kept outputs, finiteness, and the loss against a forward
    kept, checks = None, []
    for j in range(CAPTURE_REPLAYS):
        ref = float(cap.loss(cap.forward(scene), scene)) if j % CAPTURE_CHECK_EVERY == 0 else None
        out = train_step(cap, scene)
        loss = float(out[0])
        if not math.isfinite(loss):
            raise SmokeFailure(f"captured {label}: replay {j + 1} loss {loss!r}")
        if kept is not None and float(kept[0]) != kept[1]:
            raise SmokeFailure(f"captured {label}: replay {j}'s kept loss {kept[1]!r} became "
                               f"{float(kept[0])!r} after the next replay")
        kept = (out[0], loss)
        if ref is not None:
            checks.append((j + 1, loss, ref))
            if abs(loss - ref) > SLICE_RTOL * abs(ref):
                raise SmokeFailure(f"captured {label}: replay {j + 1} loss {loss!r} vs a forward's "
                                   f"{ref!r}")
    if graphs() != recorded:
        raise SmokeFailure(f"captured {label}: recorded again during the replays")
    print(f"captured {label}: {CAPTURE_REPLAYS} more replays: losses finite, each kept loss "
          f"unchanged by the next replay, the step's loss against a forward's just before "
          f"(replay, step, forward) {checks} (rtol {SLICE_RTOL:g}) ok")

    # checkpoint, 2 steps (A), restore in place, the same 2 steps (B)
    adam = cap.optimizer.adam.state
    at = cap.optimizer.schedule_count  # the batches taken so far
    ptrs = [t.data_ptr() for p in cap.params for t in (p, *adam[p].values())]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, cap, step=at)
        save_s = time.perf_counter() - t0
        a = [[float(v) for v in train_step(cap, scene)] for _ in range(2)]
        a_params = [p.detach().clone() for p in cap.params]
        a_count = (cap.optimizer.schedule_count, float(adam[cap.params[0]]["step"]))
        if restore_checkpoint(tmp, cap) != at:
            raise SmokeFailure(f"captured {label}: restored another step")
    if [t.data_ptr() for p in cap.params for t in (p, *adam[p].values())] != ptrs:
        raise SmokeFailure(f"captured {label}: the restore moved a tensor")
    b = [[float(v) for v in train_step(cap, scene)] for _ in range(2)]
    b_count = (cap.optimizer.schedule_count, float(adam[cap.params[0]]["step"]))
    v_err, p_err, ok = compare(sum(b, []), sum(a, []), cap.params, a_params, range(at, at + 2),
                               eager_bitwise)
    same_graphs = graphs() == recorded
    if not ok or a_count != b_count or not same_graphs:
        raise SmokeFailure(f"captured {label}: after the restore {b} {b_count} vs {a} {a_count} "
                           f"(parameters max |err| {p_err:.3e}; same graphs {same_graphs})")
    del a_params
    peak = torch.cuda.max_memory_allocated(dev)
    E = scene.graph.num_edges
    print(f"captured {label}: checkpoint (written in {save_s:.1f} s), 2 steps, restore in place "
          f"(no tensor moved, no new recording), the same 2 steps: equal ({rule}; values "
          f"{a}) ok; ms/step median of 3: captured {ms['captured']:.3f} "
          f"({E / ms['captured'] * 1e3:.4g} edges/s), eager {ms['eager']:.3f}; port kernel launches per step "
          f"{sum(per_call.values())}, recorded once; peak device memory "
          f"{peak / 2**20:.1f} MiB (three sessions and the graphs)")
    record.setdefault("captured", {})[label] = dict(
        edges=E, rule=rule, eager_bitwise=eager_bitwise,
        steps=[dict(captured=st[0], eager=st[1], eager2=st[2], values_err=st[5],
                    params_err=st[6]) for st in steps],
        launches_per_call=launches, kernel_launches_per_step=sum(per_call.values()),
        operand_copies_recorded=recorded_copies,
        ms_captured=ms["captured"], ms_eager=ms["eager"], replay_checks=checks,
        checkpoint_steps=a, peak_bytes=peak)
    del sessions, cap, eager
    gc.collect()  # a captured session's programs refer back to it
    torch.cuda.empty_cache()


def unfused_dual_check(dev, scene_name, scene, counters, record):
    """``use_norm_proj_update = false`` with a one-layer projection-update
    MLP, at the flagship's widths and 2 layers (reduced depth), on a scene
    of at most 1024 cameras: the unfused layer (ReLU prologue, materialized
    update + MLP) through the dual kernel. One request and one step's
    gradients, counters zeroed just before and read just after each, exact
    launches; the outputs against the plain path on the card, the gradients
    of the kernel and plain paths against the plain path in float64."""
    import copy

    from gasfm_tpu_torch.losses import ESFMLoss, FLAGSHIP_LOSS
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
    from gasfm_tpu_torch.tools.profile_forward import FLAGSHIP
    from gasfm_tpu_torch.train.loop import TrainingSession

    L = 2
    model = GraphAttnSfMNet(**dict(FLAGSHIP, num_layers=L, use_norm_proj_update=False,
                                   n_hidden_layers_proj_update=1),
                            generator=torch.Generator().manual_seed(0))
    ref = TrainingSession(copy.deepcopy(model).double(), ESFMLoss(**FLAGSHIP_LOSS), device=dev,
                          capture=False)
    session = TrainingSession(model, ESFMLoss(**FLAGSHIP_LOSS), device=dev, capture=False)
    fwd = {"fused_dual_attend": L + 1, "fused_edge_combine": L, "fused_esfm_terms": 1}
    bwd = {"fused_dual_attend_bwd": L + 1, "fused_edge_combine_bwd": L, "fused_esfm_terms_bwd": 1}

    def counted(fn, want):
        for c in counters.values():
            c.launches = 0
        out = fn()
        got = {k: c.launches for k, c in counters.items()}
        if got != {k: want.get(k, 0) for k in counters}:
            raise SmokeFailure(f"unfused dual {scene_name}: launches {got}, expected {want}")
        return out

    pred = counted(lambda: session.forward(scene), {k: v for k, v in fwd.items()
                                                      if k != "fused_esfm_terms"})
    loss = session.loss(pred, scene)
    ref_pred = session.forward(scene, plain=True)
    errs = {}
    for key, got, want in (("Ps_norm", pred["Ps_norm"], ref_pred["Ps_norm"]),
                           ("pts3D", pred["pts3D"], ref_pred["pts3D"]),
                           ("loss", loss.reshape(1),
                            session.loss(ref_pred, scene, plain=True).reshape(1))):
        errs[key], ok = max_err(got, want, SLICE_RTOL, SLICE_ATOL)
        if not ok:
            raise SmokeFailure(f"unfused dual {scene_name}: {key} kernel vs plain max err "
                               f"{errs[key]:.3e}")
    grads = counted(lambda: session.loss_and_grads(scene)[2], {**fwd, **bwd})
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    gerrs, G = param_grad_errors(names, grads, session.loss_and_grads(scene, plain=True)[2],
                                 ref.loss_and_grads(float64_scene(scene), plain=True)[2])
    bad = [t for t in gerrs if not t[-1]]
    if bad:
        raise SmokeFailure(f"unfused dual {scene_name}: gradients out of tolerance: "
                           f"{[t[:4] for t in bad[:8]]}")
    wk, wp = max(t[1] for t in gerrs), max(t[2] for t in gerrs)
    print(f"unfused dual {scene_name} (use_norm_proj_update = false, projection-update MLP, "
          f"{L} layers): launches per request {fwd}, per step also {bwd}; kernel vs plain "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; step-1 gradients against float64: kernel path {wk:.3e}, plain float32 {wp:.3e} "
          f"(G = {G:.4g}) ok")
    record["unfused_dual_check"] = dict(scene=scene_name, layers=L, kernel_vs_plain=errs,
                                        grad_err_kernel=wk, grad_err_plain=wp, G=G)


# ---------------------------------------------------------------------------
# phase 14: sessions from the shipped confs, and the recorded forward
# ---------------------------------------------------------------------------

SYNTH_CONFS = ("synth/optim_synth_gasfm.conf", "synth/optim_synth_dpesfm.conf",
               "synth/optim_synth_depth_gasfm.conf", "synth/optim_synth_proj_gasfm.conf")


def forward_launches(per_request):
    """One request's launches without the loss's: a recorded forward's."""
    return {k: v for k, v in per_request.items() if not k.startswith("fused_esfm_terms")}


def counted_launches(counters, fn):
    before = {k: c.launches for k, c in counters.items()}
    out = fn()
    return out, {k: c.launches - before[k] for k, c in counters.items() if c.launches != before[k]}


def conf_loss_kw(conf):
    """The keyword arguments of the loss a conf builds (``get_loss_func``):
    the ESFM or depth loss's attributes are its constructor's arguments."""
    from gasfm_tpu_torch.losses import get_loss_func

    return dict(vars(get_loss_func(conf)))


def conf_vs_preset_check(dev, label, conf_name, preset_model, preset_loss_kw, preset_optim,
                         scene, steps, record):
    """The session of a shipped conf (``load_config`` -> ``init_model`` ->
    ``TrainingSession.from_conf``, captured: the session's default on the
    card) against the preset session from a generator of the same seed:
    equal ``state_dict``s bitwise, then ``steps`` captured steps of each
    (the warm-up, the recording, replays) equal bitwise, values and every
    parameter."""
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.main import init_model
    from gasfm_tpu_torch.tools.profile_forward import train_step
    from gasfm_tpu_torch.train.loop import TrainingSession

    conf = load_config(conf_name)
    model, n_params = init_model(conf)
    sd, psd = model.state_dict(), preset_model.state_dict()
    if list(sd) != list(psd) or not all(torch.equal(sd[k], psd[k]) for k in sd):
        raise SmokeFailure(f"conf {label}: {conf_name}'s model differs from the preset's")
    ours = TrainingSession.from_conf(conf, model, device=dev)
    preset = TrainingSession(preset_model, make_loss(preset_loss_kw), device=dev,
                             optim=preset_optim)
    if not (ours.capture and preset.capture):
        raise SmokeFailure(f"conf {label}: a CUDA session does not record its steps")
    values = []
    for k in range(steps):
        a = [float(v) for v in train_step(ours, scene)]
        b = [float(v) for v in train_step(preset, scene)]
        if a != b or not all(torch.equal(x, y) for x, y in zip(ours.params, preset.params)):
            raise SmokeFailure(f"conf {label}: captured step {k + 1} {a} vs the preset's {b}")
        values.append(a)
    print(f"conf {label}: {conf_name} -> init_model ({n_params} parameters, seed "
          f"{conf.get_int('random_seed')}) -> TrainingSession.from_conf: state_dict equal to the "
          f"preset session's bitwise; {steps} captured steps (warm-up, recording"
          f"{', replays' if steps > 2 else ''}) equal to the preset's bitwise, values {values} ok")
    record.setdefault("conf_sessions", {})[label] = dict(conf=conf_name, params=n_params,
                                                         steps=values)
    del ours, preset
    gc.collect()  # a captured session's programs refer back to it
    torch.cuda.empty_cache()


def recorded_forward_check(dev, label, model, loss_kw, optim, scene, counters, record,
                           per_request=None):
    """The evaluation forward recorded as a CUDA graph (the captured
    session's ``forward``) against the eager one from the same weights:
    REQUESTS requests of two eager sessions and a captured one side by side
    (the captured one's warm-up, recording, replays), captured against
    eager bitwise where the two eager runs agree bitwise, else within the
    serving tolerance (it prints which held); launches: the warm-up and the
    recording a request's each (``per_request``, else an eager request's),
    a replay none. Then the captured session's step warm-up, recording and
    a replay, and its forward replayed against an eager forward at the
    same weights (the eager session's parameters copied from it). ms per
    request captured and eager (median of 3) and device memory printed."""
    import copy

    from gasfm_tpu_torch.tools.profile_forward import train_step
    from gasfm_tpu_torch.train.loop import TrainingSession

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sessions = {k: TrainingSession(copy.deepcopy(model), make_loss(loss_kw), device=dev,
                                   optim=optim, capture=k == "captured")
                for k in ("eager", "eager2", "captured")}
    cap, eager, eager2 = sessions["captured"], sessions["eager"], sessions["eager2"]
    if per_request is None:
        per_request = counted_launches(counters, lambda: eager.forward(scene))[1]
    want_one = {k: v for k, v in per_request.items() if v}

    def compare(got, want):
        """(max |err| over the outputs, bitwise equal, within the tolerance)"""
        errs = [max_err(got[k], want[k], SLICE_RTOL, SLICE_ATOL) for k in want]
        return (max(e for e, _ in errs), all(torch.equal(got[k], want[k]) for k in want),
                all(ok for _, ok in errs))

    rows, eager_bitwise, kept = [], True, []
    mib = 2 ** 20
    for k in range(REQUESTS):
        e, e2 = eager.forward(scene), eager2.forward(scene)
        if k == 1:  # the recording: the memory its graph's private pool keeps
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved_before = torch.cuda.memory_reserved(dev)
            peak_before = torch.cuda.max_memory_allocated(dev)
        c, delta = counted_launches(counters, lambda: cap.forward(scene))
        if k == 1:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved_after = torch.cuda.memory_reserved(dev)
        expect = want_one if k < 2 else {}
        if delta != expect:
            raise SmokeFailure(f"recorded forward {label}: request {k + 1} launches {delta}, "
                               f"expected {expect}")
        eager_bitwise &= all(torch.equal(e[x], e2[x]) for x in e)
        rows.append(compare(c, e))
        kept.append((c, {x: v.clone() for x, v in c.items()}))
    rule = "bitwise" if eager_bitwise else "tolerance"
    bad = [k + 1 for k, r in enumerate(rows) if not (r[1] if eager_bitwise else r[2])]
    if bad or not all(torch.equal(a[x], b[x]) for a, b in kept for x in a):
        raise SmokeFailure(f"recorded forward {label}: requests {bad} out of the {rule} rule "
                           f"(max |err| {[r[0] for r in rows]}), or a kept prediction changed")
    prog = session_programs(cap).get(("forward", id(scene)))
    if prog is None:
        raise SmokeFailure(f"recorded forward {label}: no recording")

    # the forward after the step's warm-up, recording and a replay
    for _ in range(3):
        train_step(cap, scene)
    with torch.no_grad():
        for a, b in zip(eager.params, cap.params):
            a.copy_(b)
    after, delta = counted_launches(counters, lambda: cap.forward(scene))
    if delta:
        raise SmokeFailure(f"recorded forward {label}: a replay after the steps launched {delta}")
    err, exact, ok = compare(after, eager.forward(scene))
    moved = not all(torch.equal(after[x], kept[0][1][x]) for x in after)
    if not (exact if eager_bitwise else ok) or not moved:
        raise SmokeFailure(f"recorded forward {label}: after 3 steps the replay vs eager at the "
                           f"same weights max |err| {err:.3e} ({rule}); moved {moved}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    ms = {k: statistics.median(timed(lambda: s.forward(scene)) for _ in range(3))
          for k, s in (("captured", cap), ("eager", eager))}
    peak = torch.cuda.max_memory_allocated(dev)
    E = scene.graph.num_edges
    print(f"recorded forward {label}: {REQUESTS} requests captured (warm-up, recording, replay) "
          f"against eager from the same weights: two eager runs "
          + ("agree bitwise, and so do captured and eager" if eager_bitwise else
             "differ, so captured vs eager is held to the serving tolerance") +
          f" ({rule}; max |err| {max(r[0] for r in rows):.3e}); launches per request "
          f"{sum(want_one.values())} ({want_one}) at the warm-up and the recording, none at a "
          f"replay; the replay after the step's warm-up, recording and a replay against eager at "
          f"the same weights: max |err| {err:.3e} ({rule}) ok; ms/request median of 3: captured "
          f"{ms['captured']:.3f} ({E / ms['captured'] * 1e3:.4g} edges/s), eager "
          f"{ms['eager']:.3f}; device memory reserved (cache emptied) without the forward's "
          f"graph {reserved_before / mib:.1f} MiB, with it {reserved_after / mib:.1f} "
          f"(+{(reserved_after - reserved_before) / mib:.1f}); peak allocated "
          f"{peak_before / mib:.1f} MiB before the recording, {peak / mib:.1f} by the end "
          f"(three sessions, then the step's graph)")
    record.setdefault("recorded_forward", {})[label] = dict(
        edges=E, rule=rule, max_abs_err=[r[0] for r in rows], after_steps_err=err,
        launches_per_request=want_one, ms_captured=ms["captured"], ms_eager=ms["eager"],
        reserved_before_recording=reserved_before, reserved_after_recording=reserved_after,
        peak_before_recording=peak_before, peak_bytes=peak)
    del sessions, cap, eager, eager2, prog, kept, after
    gc.collect()
    torch.cuda.empty_cache()


def conf_phase(dev, scenes, counters, record, L):
    """Phase 14: sessions built from the shipped confs. Returns the
    projective flagship's training launches."""
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.data.loaders import create_scene_data
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.losses import DEPTH_LOSS, DPESFM_LOSS, FLAGSHIP_LOSS
    from gasfm_tpu_torch.main import init_model
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
    from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
    from gasfm_tpu_torch.tools.profile_forward import (DPESFM, FLAGSHIP, FLAGSHIP_DEPTH,
                                                       SCENES)
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.train.state import DPESFM_OPTIM, FLAGSHIP_OPTIM, optim_from_conf

    def seeded(seed=0):
        return torch.Generator().manual_seed(seed)

    t_phase = time.perf_counter()
    # the flagship and DPESFM from their confs against the presets
    conf_vs_preset_check(dev, "flagship", "gasfm/optim_euc_gasfm.conf",
                         GraphAttnSfMNet(**FLAGSHIP, generator=seeded()), FLAGSHIP_LOSS,
                         FLAGSHIP_OPTIM, scenes["dense"], 2, record)
    conf_vs_preset_check(dev, "dpesfm", "dpesfm/learning_euc_noaug_dpesfm.conf",
                         SetOfSetNet(**DPESFM, generator=seeded()), DPESFM_LOSS, DPESFM_OPTIM,
                         scenes["powerlaw"], 1 + TRAIN_STEPS, record)

    # the projective flagship on the dense scene generated uncalibrated
    conf = load_config("gasfm/optim_proj_gasfm.conf")
    model, _ = init_model(conf)
    t0 = time.perf_counter()
    proj = {"proj_dense": generate_synthetic_scene(**SCENES["dense"], calibrated=False)
            .to_scene_graph(device=dev)}
    g = proj["proj_dense"].graph
    print(f"conf projective: {g.num_cams} views, {g.num_pts} points, {g.num_edges} edges "
          f"(the dense scene uncalibrated, set up in {time.perf_counter() - t0:.1f} s); the "
          f"model's view head: {model.calibrated=}, {model.normalize_output=}")
    loss_kw, optim = conf_loss_kw(conf), optim_from_conf(conf)
    serving = TrainingSession(model, make_loss(loss_kw), device=dev, optim=optim, capture=False)
    with torch.no_grad():
        res = kernel_phase(dev, "proj_dense", g, serving.model, record)
    bad = [k for k, v in res.items() if not v["ok"]]
    if bad:
        raise SmokeFailure(f"projective flagship: kernels out of tolerance: {bad}")
    record["proj_serving_launches"] = slice_phase(
        dev, serving, proj, counters, record, per_step_launches(L, backward=False), "proj_slice")
    del serving
    launches = train_phase(dev, proj, counters, record, init_model(conf)[0], loss_kw, optim,
                           per_step_launches(L, backward=True), "proj_train")
    captured_phase(dev, "gasfm-proj dense", init_model(conf)[0], loss_kw, optim,
                   proj["proj_dense"], counters, per_step_launches(L, backward=True), record)

    # the recorded forward on four models
    for label, build, lkw, opt, scene, per_request in (
            ("gasfm dense", lambda: GraphAttnSfMNet(**FLAGSHIP, generator=seeded()),
             FLAGSHIP_LOSS, FLAGSHIP_OPTIM, scenes["dense"],
             forward_launches(per_step_launches(L, backward=False))),
            ("gasfm-proj dense", lambda: init_model(conf)[0], loss_kw, optim,
             proj["proj_dense"], forward_launches(per_step_launches(L, backward=False))),
            ("dpesfm powerlaw", lambda: SetOfSetNet(**DPESFM, generator=seeded()), DPESFM_LOSS,
             DPESFM_OPTIM, scenes["powerlaw"], None),
            ("gasfm-depth dense",
             lambda: GraphAttnSfMNet(**FLAGSHIP_DEPTH, generator=seeded(DEPTH_SEEDS["gasfm"])),
             DEPTH_LOSS, FLAGSHIP_OPTIM, scenes["dense"], depth_step_launches(L, backward=False))):
        if per_request is None:  # DPESFM's, from its layer count
            per_request = forward_launches(dpesfm_step_launches(build(), backward=False))
        recorded_forward_check(dev, label, build(), lkw, opt, scene, counters, record,
                               per_request)

    # the single-scene synthetic confs, each on its own scene
    for name in SYNTH_CONFS:
        conf = load_config(name)
        data = create_scene_data(conf)
        scene = data.to_scene_graph(device=dev)
        model, n_params = init_model(conf)
        loss_kw, optim = conf_loss_kw(conf), optim_from_conf(conf)
        eager = TrainingSession(init_model(conf)[0], make_loss(loss_kw), device=dev, optim=optim,
                                capture=False)
        per_step = counted_launches(counters, lambda: eager.loss_and_grads(scene))[1]
        del eager
        label = name.split("/")[-1][:-len(".conf")]
        print(f"conf {label}: {data.num_views} views, {data.num_points} points, "
              f"{scene.graph.num_edges} edges (create_scene_data); {n_params} parameters; "
              f"launches per forward + loss + backward {per_step}")
        captured_phase(dev, label, model, loss_kw, optim, scene, counters, per_step, record,
                       adam_bound=isinstance(model, SetOfSetNet))
        recorded_forward_check(dev, label, init_model(conf)[0], loss_kw, optim, scene, counters,
                               record)
    record["conf_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14 (sessions from the shipped confs): {record['conf_phase_s']:.1f} s")
    return launches


# phase 15: single-scene optimization through the port's CLI
# ---------------------------------------------------------------------------

DENSE_SYNTH = ("dataset.synthetic.enabled=true", "dataset.synthetic.n_views=128",
               "dataset.synthetic.n_points=8192", "dataset.synthetic.visibility=0.2")
# (label, conf, external params): the flagships on the dense scene's sizes
# (profile_forward.SCENES["dense"]), the warm-up cut with the run (2,500 of
# the conf's 100,000 epochs; 3 of these 30), one evaluation between the
# first and the last, and the final evaluation with bundle adjustment; the
# synthetic confs at their own sizes.
CLI_RUNS = (
    ("flagship", "gasfm/optim_euc_gasfm.conf",
     DENSE_SYNTH + ("train.n_epochs=30", "eval.eval_interval=10",
                    "train.lr_schedule.lr_warmup_n_steps=3")),
    ("flagship-proj", "gasfm/optim_proj_gasfm.conf",
     DENSE_SYNTH + ("train.n_epochs=10", "eval.eval_interval=5",
                    "train.lr_schedule.lr_warmup_n_steps=1")),
) + tuple((name.split("/")[-1][:-len(".conf")], name, ("train.n_epochs=20", "eval.eval_interval=10"))
          for name in SYNTH_CONFS)
CLI_KEEP_BYTES = 1 << 20  # larger artifacts are checked, listed and deleted


@contextlib.contextmanager
def stdout_to(path):
    """File descriptor 1 (Python's prints and the BA solver's printf) into
    ``path`` for the block."""
    import ctypes
    import os

    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    libc.fflush(None)
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            libc.fflush(None)
            os.dup2(saved, 1)
            os.close(saved)


@contextlib.contextmanager
def cli_probe(counters):
    """Record every call of the session's step, update and forward and of the
    evaluation's stages while the CLI runs: (kind, host start, host end, the
    port kernels it launched, what it returned)."""
    from gasfm_tpu_torch.experiments import single_scene
    from gasfm_tpu_torch.train import loop

    calls = []
    patched = []

    def wrap(owner, name, kind):
        fn = getattr(owner, name)

        def wrapped(*args, **kwargs):
            before = {k: c.launches for k, c in counters.items()}
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            t1 = time.perf_counter()
            calls.append((kind, t0, t1, {k: c.launches - before[k] for k, c in counters.items()
                                         if c.launches != before[k]}, out))
            return out

        patched.append((owner, name, fn))
        setattr(owner, name, wrapped)

    for name, kind in (("fused_step", "step"), ("loss_and_grads", "step"), ("update", "update"),
                       ("forward", "forward")):
        wrap(loop.TrainingSession, name, kind)
    wrap(loop, "prepare_predictions", "prepare")
    wrap(loop, "compute_errors", "errors")
    wrap(loop, "epoch_evaluation", "eval")
    wrap(single_scene, "epoch_evaluation", "eval")
    try:
        yield calls
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)


def cli_run(label, conf_name, ext, counters, record, out_dir):
    """One ``main(["single-scene-optim", ...])`` on the card, its output in
    ``<out_dir>/<label>.log``. Checks: from the third step on no step, update
    or forward launched a port kernel (each replays its recording); the final
    row's ``our_repro`` below the first evaluation's (explicit heads), and
    ``repro_ba <= our_repro + 1e-6`` where bundle adjustment ran; the tree
    complete. Returns the run's summary."""
    import os
    import shutil

    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.main import main as cli_main
    from gasfm_tpu_torch.utils.observability import reset_tb_writer

    exp = out_dir / label
    if exp.exists():
        shutil.rmtree(exp)
    argv = ["single-scene-optim", "--conf", conf_name, "--exp-dir", str(exp),
            "--external-params", *ext]
    t0 = time.perf_counter()
    with cli_probe(counters) as calls, stdout_to(out_dir / f"{label}.log"):
        rc = cli_main(argv)
        reset_tb_writer()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"CLI {label}: main returned {rc}")
    conf = load_config(conf_name, external_params=list(ext))
    explicit = conf.get_bool("model.view_head.enabled")
    calibrated = conf.get_bool("dataset.calibrated")
    run_ba = conf.get_bool("ba.run_ba")
    scene = conf.get_string("dataset.scene")

    # replays: every step, update and forward after a recording's second call
    by_kind = collections.defaultdict(list)
    for c in calls:
        by_kind[c[0]].append(c)
    steps = by_kind["step"]
    n_epochs = conf.get_int("train.n_epochs")
    if len(steps) != n_epochs:  # one batch per epoch: a fused step, or loss_and_grads
        raise SmokeFailure(f"CLI {label}: {len(steps)} steps for {n_epochs} epochs")
    late = [(kind, i + 1, c[3]) for kind in ("step", "update", "forward")
            for i, c in enumerate(by_kind[kind]) if i >= 2 and c[3]]
    if late:
        raise SmokeFailure(f"CLI {label}: port kernels launched after a recording: {late[:5]}")
    first_steps = [c[3] for c in steps[:2]]
    first_forwards = [c[3] for c in by_kind["forward"][:2]]
    if not first_steps[0] or first_steps[0] != first_steps[1]:
        raise SmokeFailure(f"CLI {label}: the warm-up and recording steps launched "
                           f"{first_steps}")

    # the loop's ms per step over steps 3..N (host clock, the intervals
    # between step calls with no evaluation in between)
    evals = [(c[1], c[2]) for c in by_kind["eval"]]
    gaps = [1e3 * (b[1] - a[1]) for a, b in zip(steps[2:], steps[3:])
            if not any(a[1] < e0 < b[1] for e0, _ in evals)]
    ms_step = statistics.median(gaps) if gaps else float("nan")

    # learning and BA, from the tables the evaluations returned
    tables = [c[4] for c in by_kind["eval"]]
    first, final = tables[0], tables[-1]
    row = {c: final.loc(scene, c) for c in final.columns}
    if explicit:
        repro0 = first.loc(scene, "our_repro")
        if not row["our_repro"] < repro0:
            raise SmokeFailure(f"CLI {label}: our_repro {row['our_repro']} not below the first "
                               f"evaluation's {repro0}")
        if run_ba and not row["repro_ba"] <= row["our_repro"] + 1e-6:
            raise SmokeFailure(f"CLI {label}: repro_ba {row['repro_ba']} > our_repro "
                               f"{row['our_repro']}")
    bad = [c for c, v in row.items() if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise SmokeFailure(f"CLI {label}: non-finite metrics {bad}")

    # the final evaluation's seconds
    t_eval = by_kind["eval"][-1]
    inside = [c for c in calls if t_eval[1] <= c[1] and c[2] <= t_eval[2]]
    fwd = row["Inference time"]  # the forward between two synchronisations
    prep = [c for c in inside if c[0] == "prepare"]
    ba_s = sum(c[4].get("ba_time", 0.0) for c in prep)
    prep_s = sum(c[2] - c[1] for c in prep) - ba_s
    err_s = sum(c[2] - c[1] for c in inside if c[0] == "errors")

    # the tree
    sdir = exp / "OPTIMIZATION" / scene
    need = [exp / "final_train_errors_OPTIMIZATION.csv",
            exp / "final_train_errors_OPTIMIZATION.xlsx",
            sdir / "models" / "final_model.npz", sdir / "predictions" / "final_predictions.npz",
            exp / "code" / "exp.conf.json", exp / "code" / "gasfm_tpu_torch" / "main.py"]
    if calibrated and explicit:
        need.append(sdir / "plots" / "final_plots.html")
    missing = [str(p.relative_to(exp)) for p in need if not p.exists()]
    events = list((exp / "tb").glob("events.out.tfevents.*"))
    if missing or len(events) != 1 or events[0].stat().st_size < 100:
        raise SmokeFailure(f"CLI {label}: missing {missing}, event files {events}")
    header = (exp / "final_train_errors_OPTIMIZATION.csv").read_text().splitlines()[0]
    files = sorted((str(p.relative_to(exp)), p.stat().st_size) for p in exp.rglob("*")
                   if p.is_file() and "code/gasfm_tpu_torch" not in str(p))
    shutil.rmtree(exp / "code" / "gasfm_tpu_torch")
    for rel, size in files:
        if size > CLI_KEEP_BYTES:
            os.remove(exp / rel)

    summary = dict(conf=conf_name, external_params=list(ext), wall_s=wall, steps=len(steps),
                   ms_per_step_3_to_n=ms_step, step_gaps_ms=gaps,
                   launches_first_steps=first_steps, launches_first_forwards=first_forwards,
                   forwards=len(by_kind["forward"]), evaluations=len(evals),
                   final_eval_s=dict(forward=fwd, prepare_without_ba=prep_s, ba=ba_s,
                                     compute_errors=err_s, whole=t_eval[2] - t_eval[1]),
                   first_our_repro=first.loc(scene, "our_repro") if explicit else None,
                   final_row=row, csv_columns=header.split(","), files=files)
    record.setdefault("cli", {})[label] = summary
    print(f"CLI {label} ({conf_name}, {' '.join(ext)}): {len(steps)} steps, "
          f"{len(by_kind['forward'])} forwards in {len(evals)} evaluations, {wall:.1f} s; port "
          f"kernels: warm-up step {sum(first_steps[0].values())}, recording "
          f"{sum(first_steps[1].values())}, steps 3..{len(steps)} and forwards 3.."
          f"{len(by_kind['forward'])} none (replays) ok; loop {ms_step:.3f} ms/step over steps "
          f"3..{len(steps)} (median of {len(gaps)} host intervals); final evaluation "
          f"{t_eval[2] - t_eval[1]:.2f} s: forward {fwd:.3f}, prepare_predictions without BA "
          f"{prep_s:.2f}, BA {ba_s:.2f}, compute_errors {err_s:.2f}; our_repro "
          + (f"{summary['first_our_repro']:.3f} -> {row['our_repro']:.3f}" if explicit else "n/a")
          + (f", repro_ba {row['repro_ba']:.4g}" if explicit and run_ba else "")
          + f"; tree complete ({len(files)} files, those over {CLI_KEEP_BYTES >> 20} MiB "
          f"deleted after the check)")
    return summary


def cli_phase(counters, record):
    """Phase 15: the port's CLI (``gasfm_tpu_torch.main.main``) in this
    process on the flagships at full width on the dense scene's sizes and on
    the four single-scene synthetic confs; its experiments under
    ``chiprun_out/phase15/``."""
    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / "phase15"
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, conf_name, ext in CLI_RUNS:
        cli_run(label, conf_name, ext, counters, record, out_dir)
        gc.collect()  # the run's session (its recordings refer back to it)
        torch.cuda.empty_cache()
    dense = record["captured"]["gasfm dense"]["ms_captured"]
    cli = record["cli"]["flagship"]["ms_per_step_3_to_n"]
    print(f"phase 15: the CLI loop's flagship step {cli:.3f} ms against phase 12b's captured "
          f"dense step {dense:.3f} ms ({cli / dense:.3f}x), {nvidia_smi_line()}")
    record["cli_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 15 (single-scene optimization through the CLI): {record['cli_phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: multi-scene learning through the port's CLI
# ---------------------------------------------------------------------------


def dual_unfused_step_launches(L, backward):
    """Exact kernel launches of one forward + loss (and, with ``backward``,
    of its backward) through an L-layer GASFM model off the merged path on
    a scene of at most 1024 cameras (a width other than 32, as the
    synthetic confs' 16): per layer the frontend (with its dual core) and
    the edge combine, the final aggregation's dual core, the loss terms
    once; the backward the same."""
    fwd = {"fused_frontend": L, "fused_dual_attend": L + 1, "fused_edge_combine": L,
           "fused_esfm_terms": 1}
    bwd = {"fused_frontend_bwd": L, "fused_dual_attend_bwd": L + 1,
           "fused_edge_combine_bwd": L, "fused_esfm_terms_bwd": 1}
    return {**fwd, **{k: v if backward else 0 for k, v in bwd.items()}}


def with_repro(per_step):
    """A fused step's launches: the forward, loss and backward's, and
    our_repro's gathers."""
    out = dict(per_step)
    for k, v in REPRO_LAUNCHES.items():
        out[k] = out.get(k, 0) + v
    return out


# The learning confs' lists cut to 3 training scenes (4 for DPESFM's batches
# of 4), 1 validation and 1 test scene (synthetic scenes named after them)
LISTS = ('dataset.validation_set=["GoldenStatueSomewhereInHongKong"]',
         'dataset.test_set=["AlcatrazCourtyard"]')
TRAIN3 = 'dataset.train_set=["EcoleSuperiorDeGuerre","DoorLund","ParkGateClermontFerrand"]'
TRAIN4 = ('dataset.train_set=["EcoleSuperiorDeGuerre","DoorLund","ParkGateClermontFerrand",'
          '"StatueOfLiberty"]')
# (label, conf, external params, the launches of a sampled step given the
# session's model): GASFM at full width on the dense scene's sizes, 20
# epochs (2,500 warm-up steps cut to 3), evaluations at init and after
# epochs 1, 10 and 20, 4 fine-tuning epochs, no BA (phase 15 runs it), no
# weight file and prediction dump at each phase's first evaluation (580 MB a
# file); a profiler window over epochs 6-7 (no evaluation inside; past the
# fine-tuning phases' 4 epochs, which take the same keys). DPESFM with
# outliers in batches of 4 on 64-view scenes, 6 epochs, a profiler window over
# epoch 4. The synthetic conf as shipped.
MSL_RUNS = (
    ("gasfm", "gasfm/learning_euc_rhaug-15-20_gasfm.conf",
     DENSE_SYNTH + LISTS + (TRAIN3, "train.n_epochs=20", "eval.eval_interval=10",
                            "train.lr_schedule.lr_warmup_n_steps=3", "train.finetune_n_epochs=4",
                            "ba.run_ba=false", "train.finetune_dump_model_interval=null",
                            "train.finetune_dump_and_plot_pred_interval=null",
                            "observability.profile_start_epoch=5",
                            "observability.profile_n_epochs=2"),
     lambda m: with_repro(per_step_launches(len(m.equivariant_blocks), backward=True))),
    ("dpesfm-outliers", "dpesfm/learning_euc_rhaug-15-20_outliers0.1_dpesfm.conf",
     ("dataset.synthetic.enabled=true", "dataset.synthetic.n_views=64",
      "dataset.synthetic.n_points=2048", "dataset.synthetic.visibility=0.3") + LISTS
     + (TRAIN4, "train.n_epochs=6", "eval.eval_interval=3", "train.finetune_n_epochs=2",
        "ba.run_ba=false", "observability.profile_start_epoch=3",
        "observability.profile_n_epochs=1"),
     lambda m: dpesfm_step_launches(m, backward=True)),
    ("synth", "synth/learning_synth_gasfm.conf", (),
     lambda m: with_repro(dual_unfused_step_launches(len(m.equivariant_blocks), backward=True))),
)
PROFILED = re.compile(r"\[profiler\] epochs (\d+)\.\.(\d+): wall ([\d.]+) ms, device kernel time "
                      r"([\d.]+) ms in (\d+) kernels, busy share ([\d.]+)")


def scene_bytes(scene):
    """Device bytes of a scene graph: its tensors and its splits' tables."""
    g = scene.graph
    tensors = [getattr(g, f.name) for f in dataclasses.fields(g)]
    tensors += [c.table for side in ("_pt_chunks", "_cam_chunks")
                for c in g.__dict__.get(side, {}).values()]
    tensors += [scene.Ns, scene.Ns_inv, scene.Ps_gt]
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def msl_probe(counters):
    """What a multi-scene CLI run did: every step, update and forward call
    (its kind, the phase it ran in, host start and end, the port kernels it
    launched, the recordings made inside it; for a forward whether its
    scene had a recording before and which fixed evaluation scene it was;
    for a sampled step its scene's sizes and bytes), the device memory
    allocated after each training epoch, the loader's wait per batch, the
    host seconds of each outlier injection and graph host half, the
    recordings the session holds after training, the train stats, and for
    a batch of several samples whether the update took the sum of their
    gradients (one batch, after the first epoch)."""
    from gasfm_tpu_torch import experiments
    from gasfm_tpu_torch.data import outliers, scene as scene_mod
    from gasfm_tpu_torch.train import loop
    from gasfm_tpu_torch.utils.phases import Phases

    st = dict(calls=[], memory=[], waits=[], host=collections.defaultdict(list), phase=None,
              fixed=[], recordings=None, stats=None, made=0, epochs=0, samples=None,
              batch_check=None, evals=[], phases=[], epoch_s=[], sampled=0, syncs=[])
    patched = []

    def patch(owner, name, make):
        fn = getattr(owner, name)
        patched.append((owner, name, fn))
        setattr(owner, name, make(fn))

    def fixed_label(session, scene):
        for d in st["fixed"]:
            if session._cache is not None and session._cache.graphs.get(id(d)) is scene:
                return d.scene_name
        return None

    def session_call(kind):
        def make(fn):
            def wrapped(self, scene, *args, **kwargs):
                training = st["phase"] == Phases.TRAINING
                had = kind == "forward" and any(k == "forward" and s is scene
                                                for k, s in self.recordings())
                label = fixed_label(self, scene) if kind == "forward" else None
                before = {k: c.launches for k, c in counters.items()}
                made = st["made"]
                # the second to fourth sampled steps under CUDA's sync
                # debug mode: what in them waits for the device
                watch = training and kind != "forward" and 1 <= st["sampled"] <= 3
                with warnings.catch_warnings(record=True) as caught:
                    if watch:
                        warnings.simplefilter("always")
                        torch.cuda.set_sync_debug_mode("warn")
                    t0 = time.perf_counter()
                    try:
                        out = fn(self, scene, *args, **kwargs)
                    finally:
                        t1 = time.perf_counter()
                        if watch:
                            torch.cuda.set_sync_debug_mode("default")
                if watch:
                    st["syncs"].append([str(w.message).splitlines()[0][:160] for w in caught
                                        if "called a synchronizing CUDA operation"
                                        in str(w.message)])
                if training and kind != "forward":
                    st["sampled"] += 1
                launched = {k: c.launches - before[k] for k, c in counters.items()
                            if c.launches != before[k]}
                rec = dict(kind=kind, phase=st["phase"], t0=t0, t1=t1, launched=launched,
                           recorded=st["made"] - made, session=id(self), scene=id(scene),
                           had=had, fixed=label, model=self.model)
                if kind != "forward" and training:
                    g = scene.graph
                    rec.update(views=g.num_cams, points=g.num_pts, edges=g.num_edges,
                               bytes=scene_bytes(scene), epoch=st["epochs"])
                    if kind == "loss_and_grads" and st["samples"] is not None:
                        st["samples"].append([t.detach().clone() for t in out[2]])
                st["calls"].append(rec)
                return out
            return wrapped
        return make

    def update(fn):
        def wrapped(self, grads):
            samples = st["samples"]
            if samples is not None and len(samples) > 1:
                exact = [sum(s[i].double() for s in samples) for i in range(len(grads))]
                bound = [sum(s[i].double().abs() for s in samples) * (len(samples) - 1) * 2 ** -24
                         for i in range(len(grads))]
                worst = max(float(((g.double() - e).abs() - b).max())
                            for g, e, b in zip(grads, exact, bound))
                st["batch_check"] = dict(samples=len(samples), tensors=len(grads),
                                         worst_excess=worst, ok=worst <= 0.0)
                st["samples"] = None
            return fn(self, grads)
        return wrapped

    def program_init(fn):
        def wrapped(self, *args, **kwargs):
            st["made"] += 1
            return fn(self, *args, **kwargs)
        return wrapped

    def train(fn):
        def wrapped(conf, train_loader, session, phase, *args, **kwargs):
            st["phase"] = phase
            t0 = time.perf_counter()
            try:
                out = fn(conf, train_loader, session, phase, *args, **kwargs)
            finally:
                st["phase"] = None
                st["phases"].append((phase.name, t0, time.perf_counter()))
            if phase == Phases.TRAINING:
                st["stats"] = out[1]
            return out
        return wrapped

    def epoch_train(fn):
        def wrapped(conf, session, *args, **kwargs):
            training = st["phase"] == Phases.TRAINING
            if training and st["epochs"] == 1 and st["batch_check"] is None:
                st["samples"] = []  # the second epoch's first batch of several
            t0 = time.perf_counter()
            out = fn(conf, session, *args, **kwargs)
            if training:
                st["epoch_s"].append(time.perf_counter() - t0)
                st["samples"] = None
                st["epochs"] += 1
                st["memory"].append(torch.cuda.memory_allocated())
                bad = [v for v in out[2] if not math.isfinite(v)]
                if bad:
                    raise SmokeFailure(f"non-finite training losses {bad[:5]}")
            return out
        return wrapped

    def prepare(fn):
        def wrapped(*args, **kwargs):
            gen = fn(*args, **kwargs)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    return
                if st["phase"] == Phases.TRAINING:
                    st["waits"].append(time.perf_counter() - t0)
                yield item
        return wrapped

    def timed(key):
        def make(fn):
            def wrapped(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                st["host"][key].append(time.perf_counter() - t0)
                return out
            return wrapped
        return make

    def host_graph(fn):
        def wrapped(self):
            if self._host_graph is not None:
                return fn(self)
            t0 = time.perf_counter()
            out = fn(self)
            st["host"]["host_graph"].append(time.perf_counter() - t0)
            return out
        return wrapped

    def dataloaders(fn):
        def wrapped(*args, **kwargs):
            datasets, loaders = fn(*args, **kwargs)
            st["datasets"] = datasets
            st["fixed"] = [d for key in ("train_set_for_eval", "validation_set")
                           for d in datasets[key].data_list]
            return datasets, loaders
        return wrapped

    def train_model(fn):
        def wrapped(conf, session, *args, **kwargs):
            out = fn(conf, session, *args, **kwargs)
            st["recordings"] = [(k, fixed_label(session, s) if s is not None else None)
                                for k, s in session.recordings()]
            return out
        return wrapped

    def evaluation(fn):
        def wrapped(data_loader, session, weights, conf, epoch, phase, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(data_loader, session, weights, conf, epoch, phase, *args, **kwargs)
            st["evals"].append(dict(phase=st["phase"], eval_phase=phase, epoch=epoch,
                                    outliers=kwargs.get("outlier_injection_rate"), table=out,
                                    s=time.perf_counter() - t0))
            return out
        return wrapped

    for name, kind in (("fused_step", "step"), ("loss_and_grads", "loss_and_grads"),
                       ("forward", "forward")):
        patch(loop.TrainingSession, name, session_call(kind))
    patch(loop.TrainingSession, "update", update)
    patch(loop._Program, "__init__", program_init)
    from gasfm_tpu_torch.experiments import multi_scene, single_scene

    for owner in (loop, multi_scene, single_scene):
        patch(owner, "train", train)
    patch(loop, "epoch_train", epoch_train)
    patch(loop, "_prepare_batches", prepare)
    patch(loop, "epoch_evaluation", evaluation)
    patch(outliers, "inject_outliers", timed("inject_outliers"))
    # the run's other host costs: weight files, CPU copies of the weights,
    # the profiler window's close (its trace export)
    from gasfm_tpu_torch.utils import observability

    patch(loop, "save_params", timed("save_params"))
    patch(loop.TrainingSession, "weights", timed("weights"))
    patch(observability.ProfilerWindow, "close", timed("profiler_close"))
    patch(scene_mod.SceneData, "host_graph", host_graph)
    patch(experiments, "create_eval_dataloaders", dataloaders)
    patch(experiments, "train_model", train_model)
    try:
        yield st
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)


def msl_run(label, conf_name, ext, expect, counters, record, out_dir):
    """One ``main(["multi-scene-learning", ...])`` on the card, its output in
    ``<out_dir>/<label>.log``. Checks (each raises): every sampled step
    launched exactly ``expect(model)`` and made no recording; after
    training the session held recordings of the fixed evaluation scenes
    only; the device memory allocated after epochs 2..N flat within one
    subscene's bytes; every fixed evaluation scene's forward launched no
    port kernel from its third call on; a batch of several samples updated
    with the sum of their gradients to float32 rounding; the training
    losses finite; the best validation metric no worse than the first
    evaluation's; the tree complete. Returns the run's summary."""
    import os
    import shutil

    import numpy

    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.main import main as cli_main
    from gasfm_tpu_torch.utils.observability import reset_tb_writer
    from gasfm_tpu_torch.utils.phases import Phases

    exp = out_dir / label
    if exp.exists():
        shutil.rmtree(exp)
    argv = ["multi-scene-learning", "--conf", conf_name, "--exp-dir", str(exp),
            "--external-params", *ext]
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with msl_probe(counters) as st, stdout_to(out_dir / f"{label}.log"):
        rc = cli_main(argv)
        reset_tb_writer()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"multi-scene {label}: main returned {rc}")
    conf = load_config(conf_name, external_params=list(ext))
    n_epochs = conf.get_int("train.n_epochs")
    oir = conf.get_float("train.outlier_injection_rate", default=None)

    # sampled steps: exact launches, no recording
    sampled = [c for c in st["calls"] if c["phase"] == Phases.TRAINING and c["kind"] != "forward"]
    want = expect(sampled[0]["model"])
    wrong = [(i, c["launched"]) for i, c in enumerate(sampled)
             if c["launched"] != {k: v for k, v in want.items() if v}]
    recorded = [i for i, c in enumerate(sampled) if c["recorded"]]
    if not sampled or wrong or recorded:
        raise SmokeFailure(f"multi-scene {label}: {len(sampled)} sampled steps; launches other "
                           f"than {want}: {wrong[:3]}; recordings made by steps {recorded[:5]}")
    # the session after training
    stray = [r for r in st["recordings"] if not ((r[0] == "forward" and r[1] is not None)
                                                  or r == ("update", None))]
    if stray or not st["recordings"]:
        raise SmokeFailure(f"multi-scene {label}: recordings after training {st['recordings']}")
    # memory after each epoch
    mem = st["memory"]
    biggest = max(c["bytes"] for c in sampled)
    spread = max(mem[1:]) - min(mem[1:])
    if len(mem) != n_epochs or spread > biggest:
        raise SmokeFailure(f"multi-scene {label}: memory allocated after epochs 2..N spreads "
                           f"{spread} bytes, more than a subscene's {biggest}: {mem}")
    # the fixed scenes' forwards: replays from the third call on
    per_scene = collections.defaultdict(list)
    for c in st["calls"]:
        if c["kind"] == "forward" and c["fixed"] is not None:
            per_scene[c["session"], c["fixed"]].append(c)
    late = [(k[1], i + 1, c["launched"]) for k, cs in per_scene.items() for i, c in enumerate(cs)
            if i >= 2 and (c["launched"] or not c["had"])]
    if late or not per_scene or max(len(cs) for cs in per_scene.values()) < 3:
        raise SmokeFailure(f"multi-scene {label}: fixed scenes' forwards {late[:5]}, calls "
                           f"{ {k[1]: len(cs) for k, cs in per_scene.items()} }")
    # a batch of several samples
    batch = st["batch_check"]
    if conf.get_int("dataset.batch_size") > 1 and (batch is None or not batch["ok"]):
        raise SmokeFailure(f"multi-scene {label}: the batch's gradient against its samples' sum "
                           f"{batch}")
    # best against the first evaluation
    stats = st["stats"]
    best = stats.loc(0, "best_validation_metric")
    clean = [e for e in st["evals"] if e["phase"] == Phases.TRAINING
             and e["eval_phase"] == Phases.VALIDATION and e["outliers"] is None]
    first = clean[0]["table"].loc("Mean", "our_repro")
    if not best <= first:
        raise SmokeFailure(f"multi-scene {label}: best validation our_repro {best} worse than "
                           f"the first evaluation's {first}")
    # the tree
    test_scene = conf.get_list("dataset.test_set")[0]
    ids = [f"_outlier_rate{oir:.2f}"] if oir is not None else []
    need = ["train_stats.csv", "models/final_model.npz", "models/best_model.npz"]
    need += [f"{w}_{s}_errors{o}.csv" for w in ("final", "best") for s in ("train", "val", "test")
             for o in [""] + ids]
    for ph in ("FINE_TUNE_from_final", "FINE_TUNE_from_best", "SHORT_OPTIMIZATION"):
        need += [f"{ph}/{test_scene}/models/final_model.npz",
                 f"{ph}/{test_scene}/predictions/final_predictions.npz",
                 f"final_train_errors_{ph}.csv"]
    missing = [r for r in need if not (exp / r).exists()]
    events = list((exp / "tb").glob("events.out.tfevents.*"))
    if missing or len(events) != 1:
        raise SmokeFailure(f"multi-scene {label}: missing {missing}, event files {events}")

    # the measurements
    by_epoch = collections.defaultdict(list)
    for c in sampled:
        by_epoch[c["epoch"]].append(c)
    step_ms = [1e3 * (c["t1"] - c["t0"]) for c in sampled]
    batches = len(st["waits"])
    log = (out_dir / f"{label}.log").read_text()
    prof = PROFILED.search(log)
    profiled = None if prof is None else dict(
        epochs=(int(prof[1]), int(prof[2])), wall_ms=float(prof[3]), device_ms=float(prof[4]),
        kernels=int(prof[5]), busy=float(prof[6]),
        steps=sum(len(by_epoch[e - 1]) for e in range(int(prof[1]), int(prof[2]) + 1)))
    per_sample = ("inject_outliers", "host_graph")
    host = {k: 1e3 * statistics.median(v) for k, v in st["host"].items() if v and k in per_sample}
    seconds_in = {k: sum(v) for k, v in st["host"].items() if k not in per_sample}
    samples_ms = None
    if st.get("datasets") is not None:
        ds = st["datasets"]["train_set"]
        times = []
        for i in range(8):
            t1 = time.perf_counter()
            ds.get_with_rng(i % len(ds), numpy.random.default_rng(i))
            times.append(time.perf_counter() - t1)
        samples_ms = 1e3 * statistics.median(times)
    # where the run's wall time went: each phase's train(), the TRAINING
    # phase's epochs and evaluations inside it, the rest (the loaders'
    # scenes, models, the final and best evaluations, weight files)
    seconds = {}
    for name, a, b in st["phases"]:
        seconds[name] = seconds.get(name, 0.0) + b - a
    seconds["TRAINING epochs"] = sum(st["epoch_s"])
    seconds["TRAINING evaluations"] = sum(e["s"] for e in st["evals"]
                                          if e["phase"] == Phases.TRAINING)
    seconds["outside train()"] = wall - sum(b - a for _, a, b in st["phases"])
    seconds.update({f"in {k}": v for k, v in seconds_in.items()})
    files = sorted((str(p.relative_to(exp)), p.stat().st_size) for p in exp.rglob("*")
                   if p.is_file() and "code/gasfm_tpu_torch" not in str(p))
    shutil.rmtree(exp / "code" / "gasfm_tpu_torch")
    for rel, size in files:
        if size > CLI_KEEP_BYTES:
            os.remove(exp / rel)
    summary = dict(
        conf=conf_name, external_params=list(ext), wall_s=wall, seconds=seconds, epochs=n_epochs,
        sampled_steps=len(sampled), batches=batches, launches_per_sampled_step=want,
        ms_per_sampled_step=statistics.median(step_ms), ms_per_sampled_step_all=step_ms,
        loader_wait_ms_per_batch=1e3 * statistics.median(st["waits"]),
        loader_wait_ms_max=1e3 * max(st["waits"]), host_ms_per_sample=samples_ms,
        host_ms=host, profiled=profiled,
        subscenes=dict(views=[c["views"] for c in sampled], points=[c["points"] for c in sampled],
                       edges=[c["edges"] for c in sampled], bytes_max=biggest),
        syncs_in_steps_2_to_4=st["syncs"],
        memory_after_epoch=[m - mem0 for m in mem], memory_spread_2_to_n=spread,
        recordings_after_training=st["recordings"], batch_check=batch,
        fixed_forward_calls={k[1]: len(cs) for k, cs in per_scene.items()},
        best_validation_metric=best, first_validation_our_repro=first, files=files)
    record.setdefault("msl", {})[label] = summary
    views, edges = summary["subscenes"]["views"], summary["subscenes"]["edges"]
    print(f"multi-scene {label} ({conf_name}): {n_epochs} epochs, {len(sampled)} sampled steps "
          f"in {batches} batches, {wall:.1f} s; each sampled step launched "
          f"{sum(want.values())} port kernels as expected and recorded nothing; subscenes "
          f"{min(views)}-{max(views)} views, {min(edges)}-{max(edges)} edges; "
          f"{statistics.median(step_ms):.3f} ms per sampled step (median host wall of the step "
          f"call), loader wait {summary['loader_wait_ms_per_batch']:.3f} ms per batch (max "
          f"{summary['loader_wait_ms_max']:.3f}); host ms per sample: sampling + augmentation "
          + (f"{samples_ms:.3f}" if samples_ms is not None else "n/a")
          + "".join(f", {k} {v:.3f}" for k, v in host.items())
          + (f"; profiler epochs {profiled['epochs'][0]}..{profiled['epochs'][1]}: "
             f"{profiled['device_ms']:.3f} device ms in {profiled['wall_ms']:.3f} wall ms over "
             f"{profiled['steps']} steps, busy {profiled['busy']:.4f}" if profiled else "")
          + f"; synchronising calls in sampled steps 2-4: {[len(x) for x in st['syncs']]} "
          + (f"(first: {st['syncs'][0][0]!r})" if st["syncs"] and st["syncs"][0] else "")
          + f"; memory after epochs 2..{n_epochs} flat within {spread} bytes (a subscene "
          f"{biggest}); {len(st['recordings'])} recordings after training, all fixed scenes'"
          + (f"; the batch's update = the sum of its {batch['samples']} samples' gradients"
             if batch else "")
          + f"; best validation our_repro {best:.3f} (first {first:.3f}); tree complete; "
          f"seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return summary


def msl_phase(counters, record):
    """Phase 16: the port's CLI (``main(["multi-scene-learning", ...])``) in
    this process on the GASFM learning conf at full width, DPESFM with
    outliers in batches of 4, and the synthetic conf; experiments under
    ``chiprun_out/phase16/``."""
    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / "phase16"
    out_dir.mkdir(parents=True, exist_ok=True)
    for label, conf_name, ext, expect in MSL_RUNS:
        msl_run(label, conf_name, ext, expect, counters, record, out_dir)
        gc.collect()
        torch.cuda.empty_cache()
    record["msl_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 16 (multi-scene learning through the CLI): {record['msl_phase_s']:.1f} s, "
          f"{nvidia_smi_line()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from gasfm_tpu_torch.data.scene import SceneData
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.losses import (DEPTH_LOSS, DPESFM_LOSS, FLAGSHIP_LOSS, DirectDepthLoss,
                                        ESFMLoss)
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
    from gasfm_tpu_torch.models.set_of_set import SetOfSetNet
    from gasfm_tpu_torch.ops.kernels import build
    from gasfm_tpu_torch.ops.kernels import fused_attn as fat
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls
    from gasfm_tpu_torch.ops.kernels import fused_loss as flo
    from gasfm_tpu_torch.ops.kernels import fused_proj_update as fpu
    from gasfm_tpu_torch.ops.kernels import fused_update as fu
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk
    from gasfm_tpu_torch.tools.profile_forward import (DPESFM, DPESFM_DEPTH, FLAGSHIP,
                                                       FLAGSHIP_DEPTH, SCENES)
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.train.state import DPESFM_OPTIM, FLAGSHIP_OPTIM

    t_start = time.perf_counter()
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

    # ---- scenes (with their GT depths for the depth phases; the ESFM loss
    # ignores them) and model
    t0 = time.perf_counter()
    scenes = {}
    for k in MERGED_SCENES:
        data = generate_synthetic_scene(**SCENES[k])
        t1 = time.perf_counter()
        data = SceneData(data.M, data.Ns, data.y, data.scene_name, calibrated=True,
                         store_depth_targets=True)
        tracks = data.valid_pts.sum(axis=0)
        print(f"setup: {k} scene's GT depths (host DLT triangulation in float64, tracks of up to "
              f"{int(tracks.max())} cameras) in {time.perf_counter() - t1:.1f} s")
        record.setdefault("triangulation_s", {})[k] = time.perf_counter() - t1
        scenes[k] = data.to_scene_graph(device=dev)
    model = GraphAttnSfMNet(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    session = TrainingSession(model, ESFMLoss(**FLAGSHIP_LOSS), device=dev, capture=False)
    print(f"setup: scenes and model in {time.perf_counter() - t0:.1f} s; "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    t0 = time.perf_counter()
    wide = {"wide": generate_synthetic_scene(**SCENES["wide"]).to_scene_graph(device=dev)}
    wg = wide["wide"].graph
    longest = [int((ptr[1:] - ptr[:-1]).max()) for ptr in (wg.pt_ptr, wg.cam_ptr)]
    print(f"setup: the wide scene ({SCENES['wide']}) in {time.perf_counter() - t0:.1f} s: "
          f"{wg.num_cams} views, {wg.num_pts} points, {wg.num_edges} edges, "
          f"{wg.num_edges / wg.num_cams:.1f} per camera, {wg.num_edges / wg.num_pts:.2f} per point "
          f"(at most {longest[1]} per camera, {longest[0]} per point); "
          f"host peak RSS {peak_rss_mib():.0f} MiB")
    record["wide_scene"] = dict(views=wg.num_cams, points=wg.num_pts, edges=wg.num_edges,
                                longest_point=longest[0], longest_camera=longest[1])

    # ---- phase 2: forward kernels against their plain versions, at both
    # scenes' shapes; the kernels line reports the dense scene's.
    with torch.no_grad():
        per_scene = {k: kernel_phase(dev, k, scenes[k].graph, session.model, record)
                     for k in scenes}
    # ---- phase 3: backward kernels against autograd of their plain versions
    for k in scenes:
        for name, r in backward_phase(dev, k, scenes[k].graph, record).items():
            per_scene[k][name] = r
    # ... the dual core's backward on graphs that stress its split, and the
    # layer step on a graph whose segments cross its edge tiles, with empty
    # segments and a ragged last tile
    per_scene["dual_graphs"] = dual_bwd_graph_phase(dev, scenes, record)
    # ... the loss terms (#7, #8) on the wide scene and the graphs that
    # stress #8's split
    from gasfm_tpu_torch.graph.check_graphs import (graph_with_empty_segments, hub_camera_graph,
                                                    hub_parts_graph)
    per_scene["loss_graphs"] = loss_graph_phase(
        dev, {"wide": wg, "dense_empty": graph_with_empty_segments(scenes["dense"].graph),
              "hub_camera": hub_camera_graph(scenes["dense"].graph),
              "hub_parts": hub_parts_graph(dev)}, record)
    per_scene["tile_edges"] = tile_boundary_phase(dev, record)
    # ---- phase 3b: the DPESFM path's kernels (segment sum, gather, edge
    # combine and its backward) against their plain versions
    with torch.no_grad():
        for k in scenes:
            per_scene[k].update(dpesfm_kernel_phase(dev, k, scenes[k].graph, record))
        # ... and the segment sum on the wide scene and the graphs that stress
        # its split, and the edge combine's backward on those of its point walk
        per_scene["sum_graphs"] = segment_sum_graph_phase(dev, scenes, wg, record)
        per_scene["combine_graphs"] = edge_combine_bwd_graph_phase(dev, scenes, wg, record)
    # ---- phase 3c: the unfused path's kernels (single-direction attention,
    # segment max) on the dense and wide scenes
    with torch.no_grad():
        per_scene["wide"] = {}
        for k, sc in (("dense", scenes["dense"]), ("wide", wide["wide"])):
            per_scene[k].update(unfused_kernel_phase(dev, k, sc.graph, record))
        # ... and the segment max on the graphs that stress the split it walks
        per_scene["max_graphs"] = segment_max_graph_phase(dev, scenes, record)
    # ---- phase 3d: the projection update and its backward, both scenes, and
    # on graphs that stress the backward's edge tiles and sums (a ragged last
    # tile, empty points and camera, a hub point, cameras of 31-64 edges)
    for k in scenes:
        per_scene[k].update(projection_update_phase(dev, k, scenes[k].graph, record))
    from gasfm_tpu_torch.graph.check_graphs import (degree_graph, graph_with_empty_segments,
                                                    hub_point_graph, tile_boundary_graph)
    update_graphs = {"tile_edges": tile_boundary_graph(dev),
                     "degrees": degree_graph(scenes["powerlaw"].graph),
                     "hub_point": hub_point_graph(wg, sk.SUM_ROWS),
                     "dense_empty": graph_with_empty_segments(scenes["dense"].graph)}
    for k, graph in update_graphs.items():
        per_scene[f"update_{k}"] = projection_update_phase(dev, k, graph, record, main=False)
    # ... and the frontend's backward (#4) on three of them: its tiles' and
    # spans' ragged ends, short and long segments
    per_scene["front_graphs"] = frontend_bwd_graph_phase(
        dev, {k: update_graphs[k] for k in ("tile_edges", "degrees", "hub_point")}, record)
    # ... and the frontend's forward (#3) on two of them, whole and alone
    with torch.no_grad():
        per_scene["front_fwd_graphs"] = frontend_fwd_graph_phase(
            dev, {k: update_graphs[k] for k in ("tile_edges", "degrees")}, record)
    bad = [(s, k) for s, r in per_scene.items() for k, v in r.items() if not v["ok"]]
    if bad:
        raise SmokeFailure(f"kernels out of tolerance: {bad}")

    counters = {"fused_dual_attend": fda.fused_dual_attend,
                "fused_dual_attend_bwd": fda.fused_dual_attend_bwd,
                "fused_frontend": fda.fused_frontend, "fused_frontend_bwd": fda.fused_frontend_bwd,
                "fused_layer_step": fls.fused_layer_step,
                "fused_layer_step_bwd": fls.fused_layer_step_bwd,
                "fused_esfm_terms": flo.fused_esfm_terms,
                "fused_esfm_terms_bwd": flo.fused_esfm_terms_bwd,
                "segment_sum": sk.segment_sum, "gather_rows": sk.gather_rows,
                "fused_edge_combine": fu.fused_edge_combine,
                "fused_edge_combine_bwd": fu.fused_edge_combine_bwd,
                "fused_attend": fat.fused_attend, "fused_attend_bwd": fat.fused_attend_bwd,
                "segment_max": sk.segment_max, "projection_update": fpu.projection_update,
                "projection_update_bwd": fpu.projection_update_bwd}
    L = len(model.equivariant_blocks)
    # ---- phase 4: GASFM serving
    record["serving_launches"] = slice_phase(dev, session, scenes, counters, record,
                                             per_step_launches(L, backward=False), "slice")
    # ---- phase 5: GASFM training (a main path)
    paths = {"gasfm": train_phase(
        dev, scenes, counters, record,
        GraphAttnSfMNet(**FLAGSHIP, generator=torch.Generator().manual_seed(0)), FLAGSHIP_LOSS,
        FLAGSHIP_OPTIM, per_step_launches(L, backward=True), "train")}
    # ---- phase 6: small scene, card vs CPU
    small_scene_check(dev, session, record, FLAGSHIP_LOSS, FLAGSHIP_OPTIM, "gasfm")
    # ---- phase 6b: the unfused layer through the dual kernel (no edge
    # LayerNorm, a projection-update MLP, 2 layers) on the dense scene
    unfused_dual_check(dev, "dense", scenes["dense"], counters, record)
    # ---- phase 6c: the same flagship model object serves the wide scene
    # (1280 cameras: the unfused path)
    record["wide_serving_launches"] = slice_phase(
        dev, session, wide, counters, record, unfused_step_launches(L, backward=False),
        "wide_slice")
    # ---- phase 6d: GASFM training on the wide scene (a main path)
    paths["wide"] = train_phase(
        dev, wide, counters, record,
        GraphAttnSfMNet(**FLAGSHIP, generator=torch.Generator().manual_seed(0)), FLAGSHIP_LOSS,
        FLAGSHIP_OPTIM, unfused_step_launches(L, backward=True), "wide_train",
        eps64=GRAD_EPS64_WIDE)

    # ---- phase 7: DPESFM serving
    dp_model = SetOfSetNet(**DPESFM, generator=torch.Generator().manual_seed(0))
    dp_session = TrainingSession(dp_model, ESFMLoss(**DPESFM_LOSS), device=dev,
                                 optim=DPESFM_OPTIM, capture=False)
    print(f"DPESFM: {sum(p.numel() for p in dp_model.parameters())} parameters")
    record["dpesfm_serving_launches"] = slice_phase(
        dev, dp_session, scenes, counters, record,
        dpesfm_step_launches(dp_model, backward=False), "dpesfm_slice")
    # ---- phase 8: DPESFM training (a main path)
    paths["dpesfm"] = train_phase(
        dev, scenes, counters, record,
        SetOfSetNet(**DPESFM, generator=torch.Generator().manual_seed(0)), DPESFM_LOSS,
        DPESFM_OPTIM, dpesfm_step_launches(dp_model, backward=True), "dpesfm_train")
    # ---- phase 9: DPESFM small scene, card vs CPU
    small_scene_check(dev, dp_session, record, DPESFM_LOSS, DPESFM_OPTIM, "dpesfm",
                      adam_bound=True)

    # ---- phase 10: the depth flagship (the conf's depth head, DirectDepthLoss
    # L1) serves both merged scenes
    def depth_gen(model):
        return torch.Generator().manual_seed(DEPTH_SEEDS[model])

    depth_model = GraphAttnSfMNet(**FLAGSHIP_DEPTH, generator=depth_gen("gasfm"))
    depth_session = TrainingSession(depth_model, DirectDepthLoss(**DEPTH_LOSS), device=dev,
                                    capture=False)
    print(f"GASFM with the depth head: {sum(p.numel() for p in depth_model.parameters())} "
          f"parameters; per-layer plan (merged, defer) on the dense scene "
          f"{depth_model.layer_plan(scenes['dense'].graph)}")
    record["depth_serving_launches"] = slice_phase(
        dev, depth_session, scenes, counters, record, depth_step_launches(L, backward=False),
        "depth_slice")
    # ---- phase 11: its training (a main path), loss_and_grads + update
    paths["gasfm-depth"] = train_phase(
        dev, scenes, counters, record,
        GraphAttnSfMNet(**FLAGSHIP_DEPTH, generator=depth_gen("gasfm")),
        DEPTH_LOSS, FLAGSHIP_OPTIM, depth_step_launches(L, backward=True), "depth_train",
        plain_runs=DEPTH_PLAIN_RUNS)
    # ---- phase 12: DPESFM with the depth head, dense scene: serving, training
    dense = {"dense": scenes["dense"]}
    dpd_model = SetOfSetNet(**DPESFM_DEPTH, generator=depth_gen("dpesfm"))
    dpd_session = TrainingSession(dpd_model, DirectDepthLoss(**DEPTH_LOSS), device=dev,
                                  optim=DPESFM_OPTIM, capture=False)
    print(f"DPESFM with the depth head: {sum(p.numel() for p in dpd_model.parameters())} "
          "parameters")
    record["dpesfm_depth_serving_launches"] = slice_phase(
        dev, dpd_session, dense, counters, record,
        dpesfm_step_launches(dpd_model, backward=False), "dpesfm_depth_slice")
    paths["dpesfm-depth"] = train_phase(
        dev, dense, counters, record,
        SetOfSetNet(**DPESFM_DEPTH, generator=depth_gen("dpesfm")), DEPTH_LOSS,
        DPESFM_OPTIM, dpesfm_step_launches(dpd_model, backward=True), "dpesfm_depth_train",
        plain_runs=DEPTH_PLAIN_RUNS)
    for name, (_, _, path) in KERNELS.items():
        if paths[path][name] == 0:
            raise SmokeFailure(f"{name} was never launched on the {path} training path")

    # ---- phase 12b: the training step recorded as CUDA graphs (the session's
    # default on the card) on every training path, against the eager step
    def gasfm(**kw):
        return GraphAttnSfMNet(**kw, generator=torch.Generator().manual_seed(0))

    for label, build_model, loss_kw, optim, scene, per_step, bound in (
            ("gasfm dense", lambda: gasfm(**FLAGSHIP), FLAGSHIP_LOSS, FLAGSHIP_OPTIM,
             scenes["dense"], per_step_launches(L, backward=True), False),
            ("gasfm powerlaw", lambda: gasfm(**FLAGSHIP), FLAGSHIP_LOSS, FLAGSHIP_OPTIM,
             scenes["powerlaw"], per_step_launches(L, backward=True), False),
            ("gasfm wide", lambda: gasfm(**FLAGSHIP), FLAGSHIP_LOSS, FLAGSHIP_OPTIM, wide["wide"],
             unfused_step_launches(L, backward=True), False),
            ("dpesfm powerlaw",
             lambda: SetOfSetNet(**DPESFM, generator=torch.Generator().manual_seed(0)),
             DPESFM_LOSS, DPESFM_OPTIM, scenes["powerlaw"],
             dpesfm_step_launches(dp_model, backward=True), True),
            ("gasfm-depth dense",
             lambda: GraphAttnSfMNet(**FLAGSHIP_DEPTH, generator=depth_gen("gasfm")),
             DEPTH_LOSS, FLAGSHIP_OPTIM, scenes["dense"], depth_step_launches(L, backward=True),
             False)):
        captured_phase(dev, label, build_model(), loss_kw, optim, scene, counters, per_step,
                       record, adam_bound=bound)

    # ---- phase 14: sessions from the shipped confs (conf reader, builders,
    # the projective flagship) and the evaluation forward recorded
    paths["gasfm-proj"] = conf_phase(dev, scenes, counters, record, L)
    for name, (_, _, path) in KERNELS.items():
        if path == "gasfm" and paths["gasfm-proj"][name] == 0:
            raise SmokeFailure(f"{name} was never launched on the projective flagship's path")

    # ---- phase 15: single-scene optimization through the port's CLI
    # (train, evaluate, bundle adjustment, the experiment's tree)
    cli_phase(counters, record)

    # ---- phase 16: multi-scene learning through the port's CLI (sampled,
    # augmented subscenes, outliers, batches, the best model, fine-tuning)
    msl_phase(counters, record)

    # ---- phase 13: the record
    kernels = []
    for name, (source, replaces, path) in KERNELS.items():
        r = per_scene["wide" if path == "wide" else "dense"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[path][name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            burst_ms=r["burst_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms")))
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: all phases ok in {record['seconds']:.1f} s")
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
