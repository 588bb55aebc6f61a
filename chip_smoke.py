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
   projective flagship the same way for 10 epochs (``proj_ba``), its bundle
   adjustment's solves cut to 25 iterations each; the four
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
17. (after phase 16) Mixed precision, ``mixed_precision_phase``: the Adam
   kernel (``csrc/adam.cu``) against its plain version on every parameter
   tensor of the flagship (109,108,632 parameters, 673 tensors, one launch
   per update) in four configurations, (a) bf16 moments, (b) bf16 weights
   with an f32 master and bf16 moments, (c) a bf16 first moment alone and
   the master with f32 moments: bitwise after two updates (under (a) a
   third from gradients that start off 16 bytes); device ms per update
   (graph replays in a burst) beside the bound (20 / 20 / 24 / 28 bytes per
   parameter over 3.35 TB/s) and PyTorch's fused f32 Adam in the same run.
   Then the flagship's dense-scene step under (a), (b) and (c) through
   ``TrainingSession.from_conf`` (``MIXED_RUNS``), an eager and a captured
   session side by side: the step-1 loss and gradients bitwise the float32
   session's under (a) and (c); under (b) the loss within rtol 1e-2 and the
   gradients against the plain path in float64 from the same bf16 weights
   by phase 5's rule with one bf16 rounding (2^-8 x max |ref|) added, the
   largest error of ``MIXED_PLAIN_RUNS`` plain bf16 runs its yardstick; 1 +
   3 steps captured against eager bitwise (values, weights, master,
   moments, count); port launches per step phase 12b's plus one Adam; ms
   per step captured against the float32 captured step, and the replay's
   device ms by torch.profiler with the Adam kernel's share beside fused
   f32 Adam's in the float32 step; peak memory. Then
   the CLI under (b) on the synthetic GASFM conf (``cli_run``), its bf16
   weight file loaded back. Its experiment goes to ``chiprun_out/phase17/``.
18. (after phase 17) The (data, edge) mesh, over replicated tables
   (``parallel.table_sharding = false``) and table-sharded (the default
   with more than one edge shard), ``mesh_phase``: ranks spawned by
   ``gasfm_tpu_torch.parallel.run_ranks`` that share the card on a gloo
   process group (each prints its backend and device; one spawn of 2 ranks
   for [1, 2] and [2, 1], one of 4), the mesh ``TrainingSession`` from
   fresh seeded weights (``mesh_runs``): (a) the flagship (9 layers, full
   width) on the dense scene under [1, 2], replicated and table-sharded,
   step-1 loss and every gradient against the single-rank eager step on
   the card from the same weights, per tensor within phase 5's rule taken
   twice plus its ties' most, then 3 steps; the table-sharded run's forward
   and first loss also against the replicated run's, with fewer bytes
   through the edge group; (b) GASFM at 2 layers under [1, 4],
   table-sharded, and under [2, 2], 4 ranks, a group of two, both ways;
   (c) the wide scene (2 layers: unfused, #13/#14, #17/#19) and the depth
   flagship (3 layers: #9/#10) under [1, 2], both ways; (d) DPESFM under
   [1, 2], table-sharded, and under [2, 1], a group of two power-law
   scenes against the single-rank sum of their ``loss_and_grads`` +
   ``update`` (gradients, the first update's weights within lr, bitwise so
   far), a padded group of one against ``fused_step`` (the same). Every
   run: launches per rank per step those of the single-rank eager step on
   its slot's scene, the weights bitwise equal on every rank after every
   update, later losses against the single rank's (rtol 1e-3); with a
   gradient check also the forward from the first weights (the model
   forwards' tolerance); ms per step, the gradient all-reduce alone, and
   the all-reduces, bytes and host ms through the edge group per step
   (``torch.distributed.all_reduce`` wrapped in the ranks), beside phase
   5's single-rank eager step.
   (e) the CLI: ``single-scene-optim`` under [1, 2] on the synthetic GASFM
   conf, 3 epochs, over replicated tables and table-sharded: exit 0, one
   tree, a finite final our_repro; ``multi-scene-learning`` on
   ``synth/learning_synth_gasfm.conf`` under [2, 1] and [1, 2], 3 epochs in
   batches of two: exit 0, one tree, finite errors in every table
   (``chiprun_out/phase18/``).
19. (after phase 18) Multi-host ``parallel.distributed``,
   ``multihost_phase``: two launcher processes on this machine, standing
   for two hosts, meet on a TCP store at 127.0.0.1 and a free port
   (``parallel.Distributed``; process 0's launcher hosts the store), their
   ranks sharing the card over gloo, each launcher returning its own ranks
   (global rank ``process_id x local + local rank``): (a) the flagship,
   table-sharded, under [1, 2], one rank per launcher, from the fresh
   seeded weights of phase 18's run: step-1 loss and every gradient
   against phase 18's one-launcher run, per tensor within phase 5's rule
   taken twice (bitwise equality reported), then 2 more steps, the weights
   bitwise equal on both ranks after each, launches per rank per step
   those of the one launcher's, ms per step and the gradient all-reduce
   alone beside phase 18's; (d) on those ranks, the grouped evaluation
   forward's reserved bound (``TrainingSession.forward_bytes``) against its
   measured peak above what was allocated (``torch.cuda.max_memory_allocated``
   around a second call), within [peak, 2 x peak], and an evaluation with
   rank 1's reservation failing (faked) giving the scene's row of NaNs on
   rank 0; then at once (b) GASFM at 2 layers under [2, 2], two local ranks
   per launcher (global ranks 2 and 3 on process 1), against phase 18's run
   as phase 18 held it, and (c) ``multi-scene-learning`` on
   ``synth/learning_synth_gasfm.conf`` under [2, 1] as two ``python -m
   gasfm_tpu_torch.main`` processes (process ids 0 and 1, each its own
   results directory): both exit 0, one tree, process 0's, under
   ``chiprun_out/phase19/``, every table with phase 18's [2, 1] rows,
   finite, within rtol 5e-3 + atol 1e-3 of them.
20. (after phase 19) The JAX package's activation-memory options. (a)
   ``memory_kernel_phase``: the bf16 forms of the six edge-tile kernels
   (#3, #4, #5, #6, #9, #10: bf16 stream rows loaded upcast, float32 math,
   stored rounded) against their plain versions on the same bf16 inputs,
   on the dense and power-law scenes and the hub-camera graph: float32
   outputs at the kernels' tolerances (backward: the backward checks'),
   bf16 outputs within one bf16 ulp of the larger magnitude more, the
   share of elements that differ printed; each launched twice, bitwise;
   device ms per launch (``torch.profiler``) beside the f32 form's on the
   same values and each beside its bound (bf16 rows at 2 bytes). (b)-(e)
   ``memory_options_phase``: the flagship (``gasfm/optim_euc_gasfm.conf``)
   under ``compile.stream_dtype=bf16`` and under the JAX README's fast
   configuration (with bf16 Adam moments), the depth flagship under bf16
   streams (both: the largest recomputed logit above the forward's max,
   failing past the backward's shift margin), ``model.remat_layers`` on
   the power-law scene (step-1 loss and gradients bitwise without it,
   eager and captured) and the CLI with both keys; see the function.
13. A ``kernels`` JSON line (the seventeen TPU kernels' counterparts and
   the Adam kernel, each with its per-call ``ms`` and its burst
   ``burst_ms``; launches from the training path that runs each: GASFM's
   merged path for the first eight, DPESFM for the segment sum, gather and
   edge combine, the wide scene's unfused path for the attention and the
   segment max, whose times are the wide scene's, the depth flagship for
   the projection update, phase 17's (a) run for the Adam kernel, whose
   ``burst_ms`` is its device time from graph replays and ``library_ms``
   PyTorch's fused f32 Adam's; then the bf16 forms of the six edge-tile
   kernels, ``<name>_bf16``, their numbers phase 20 (a)'s on the dense
   scene, their launches phase 20 (b)'s flagship (#3-#6) and (c)'s depth
   flagship (#9, #10)), the nvidia-smi line, and the final
   ``{"ok": true, "device": ...}`` line.
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
# Phase 17 (b)'s step-1 rule likewise takes the largest error of this many
# plain bf16 runs: there each run's atomic sums also move which activations
# round up or down to bf16, so one run's error against float64 spans several
# times from run to run (the flagship's final point LayerNorm weight:
# 3.847e-05 in one run, 5.373e-05 in another, against the deterministic
# kernel path's 2.292e-04, PERF.md). The phase prints the spread where it
# matters most.
MIXED_PLAIN_RUNS = 5
SEG ="gasfm_tpu/ops/pallas/segment_kernels.py"
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
# first and the last, and the final evaluation with bundle adjustment (the
# projective one's two solves cut to 25 LM iterations each, against the
# 60 and 44 they take to converge: ~0.5 s each on the host); the synthetic
# confs at their own sizes.
CLI_RUNS = (
    ("flagship", "gasfm/optim_euc_gasfm.conf",
     DENSE_SYNTH + ("train.n_epochs=30", "eval.eval_interval=10",
                    "train.lr_schedule.lr_warmup_n_steps=3")),
    ("flagship-proj", "gasfm/optim_proj_gasfm.conf",
     DENSE_SYNTH + ("train.n_epochs=10", "eval.eval_interval=5",
                    "train.lr_schedule.lr_warmup_n_steps=1", "ba.max_iterations=25")),
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
    tensors = [t for t in tensors if isinstance(t, torch.Tensor)]  # not a shard's fields
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



# ---------------------------------------------------------------------------
# phase 17: mixed precision (bf16 Adam moments, bf16 weights with an f32
# master) through the port's Adam kernel
# ---------------------------------------------------------------------------

BF16_EPS = 2.0 ** -8
# (label, the conf's external params): (a) the JAX bench's fast
# configuration, (b) bf16 weights with an f32 master, (c) the first moment alone
MIXED_RUNS = (
    ("a", ("train.adam_mu_dtype=bf16", "train.adam_nu_dtype=bf16")),
    ("b", ("train.param_dtype=bf16", "train.adam_mu_dtype=bf16", "train.adam_nu_dtype=bf16")),
    ("c", ("train.adam_mu_dtype=bf16",)),
)
# the Adam kernel's configurations: label -> (mu bf16, nu bf16, master, bytes
# per parameter the update must move: g, mu, nu and p read, mu, nu and p
# written, plus the bf16 copy under the master)
ADAM_CONFIGS = {"a": (True, True, False, 20), "b": (True, True, True, 20),
                "c": (True, False, False, 24), "master_f32": (False, False, True, 28)}
ADAM_FLOPS = 14  # per parameter: g*g, two moments (3 each), 6 for the step, the add
ADAM_SOURCE = "gasfm_tpu_torch/csrc/adam.cu"
ADAM_REPLACES = ("port-only, no pallas_call: the JAX package's Adam is XLA "
                 "(gasfm_tpu/train/state.py:29, :86, :197)")


def graph_burst_ms(fn, reps=20) -> float:
    """Device milliseconds per call of ``fn`` (device work only), recorded
    once as a CUDA graph and replayed ``reps`` times between two events:
    the host's launch path does not count."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = burst_ms(graph.replay, reps=reps, warmup=2)
    del graph
    return ms


def adam_kernel_phase(dev, shapes, record):
    """The Adam kernel against its plain version on every parameter tensor
    of the flagship, in each configuration: two updates of each from the
    same tensors and gradients, then every tensor (the parameters or master,
    the bf16 copies, mu, nu, the count) bitwise equal (under (a) after a
    third update whose gradients are views one element into a buffer, so
    that no array of a tensor starts on 16 bytes: the kernel's element-wise
    path); times: per call
    (events around one call, the host's path included), device time per
    update (graph replays in a burst), the plain version's per call, and
    PyTorch's fused f32 Adam (``torch.optim.Adam(fused=True)``, f32
    moments, no master: another function) on the same shapes, beside the
    bound. Returns {label: result}."""
    from gasfm_tpu_torch.ops.kernels import adam as A

    n = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=dev).manual_seed(17)
    lr = torch.tensor(1e-3, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    for label, (mu_bf16, nu_bf16, master, per_param) in ADAM_CONFIGS.items():
        pdt = bf16 if master else f32
        base = [torch.randn(s, generator=gen, device=dev).to(pdt) for s in shapes]
        grads = [(torch.randn(s, generator=gen, device=dev) * 1e-2).to(pdt) for s in shapes]
        bufs = [A.AdamBuffers([t.clone() for t in base], bf16 if mu_bf16 else f32,
                              bf16 if nu_bf16 else f32, master) for _ in range(2)]
        del base
        for _ in range(2):
            A.adam_update_cuda(grads, bufs[0], lr)
            A.adam_update_plain(grads, bufs[1], lr)
        updates = 2
        if label == "a":  # gradients one element into a buffer: the kernel's unaligned path
            flat = torch.empty(n + 1, dtype=pdt, device=dev)
            views, at = [], 1
            for g in grads:
                views.append(flat[at:at + g.numel()].view(g.shape))
                at += g.numel()
            torch._foreach_copy_(views, grads)
            A.adam_update_cuda(views, bufs[0], lr)
            A.adam_update_plain(views, bufs[1], lr)
            updates += 1
            del flat, views
        pairs = [(x, y) for name in ("params", "mu", "nu")
                 for x, y in zip(getattr(bufs[0], name), getattr(bufs[1], name))]
        if master:
            pairs += list(zip(bufs[0].copies, bufs[1].copies))
        pairs.append((bufs[0].count, bufs[1].count))
        bitwise = all(torch.equal(x, y) for x, y in pairs)
        err = max(float((x.double() - y.double()).abs().max()) for x, y in pairs if x.numel())
        if not bitwise or int(bufs[0].count) != updates:
            raise SmokeFailure(f"adam {label}: kernel vs plain max |err| {err:.3e} (bitwise "
                               f"required), count {int(bufs[0].count)}")
        ms = cuda_ms(lambda: A.adam_update_cuda(grads, bufs[0], lr), reps=10)
        dev_ms = graph_burst_ms(lambda: A.adam_update_cuda(grads, bufs[0], lr))
        plain_ms = cuda_ms(lambda: A.adam_update_plain(grads, bufs[1], lr), reps=3, warmup=1)
        b_ms, by = bound_ms(per_param * n, ADAM_FLOPS * n)
        out[label] = dict(ok=True, max_abs_err=err, ms=ms, burst_ms=dev_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=by, bytes_per_param=per_param,
                          launches_per_update=len(bufs[0].launches), updates=updates)
        del bufs, grads, pairs
        torch.cuda.empty_cache()
    # the library: PyTorch's fused f32 Adam on the same shapes
    params = [torch.nn.Parameter(torch.randn(s, generator=gen, device=dev)) for s in shapes]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device=dev) * 1e-2
    fused = torch.optim.Adam(params, lr=lr, fused=True, capturable=True)
    fused.step()
    lib_ms = cuda_ms(fused.step, reps=10)
    lib_dev_ms = graph_burst_ms(fused.step)
    lib_bound, _ = bound_ms(28 * n, ADAM_FLOPS * n)
    del params, fused
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    for label, r in out.items():
        r.update(library_ms=lib_dev_ms, library_call_ms=lib_ms, library_bound_ms=lib_bound)
        print(f"adam {label} ({r['bytes_per_param']} B per parameter, {n} parameters in "
              f"{len(shapes)} tensors, {r['launches_per_update']} launch per update): kernel vs "
              f"plain bitwise after {r['updates']} updates; device ms per update {r['burst_ms']:.4f} (graph "
              f"replays), per call {r['ms']:.4f} (host included), plain {r['plain_ms']:.3f}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}; {r['bound_ms'] / r['burst_ms']:.0%} "
              f"of it reached); PyTorch's fused f32 Adam {lib_dev_ms:.4f} device ms, per call "
              f"{lib_ms:.4f} (its bound {lib_bound:.4f}); {smi} ok")
    record["adam_kernel"] = dict(out, parameters=n, tensors=len(shapes), nvidia_smi=smi)
    return out


def mixed_precision_phase(dev, scenes, counters, record, L):
    """Phase 17: mixed precision on the card. The Adam kernel against its
    plain version on the flagship's tensors (:func:`adam_kernel_phase`);
    then the flagship (``gasfm/optim_euc_gasfm.conf``, full width, its
    ``random_seed`` init) on the dense scene under each of ``MIXED_RUNS``,
    through ``TrainingSession.from_conf``, an eager and a captured session
    side by side, the counters zeroed just before and read just after:
    - the step-1 loss against the float32 session's: bitwise under (a) and
      (c) (the weights are float32 until the first update), within rtol
      1e-2 under (b) (bf16 weights, the linears' inputs rounded to bf16);
    - the step-1 gradients: under (a) and (c) bitwise the float32 session's
      (which phase 5's rule holds against float64); under (b) against the
      plain path run in float64 from the same (bf16) weights by phase 5's
      rule (``param_grad_errors``, ``branch_ties``) with bf16's rounding
      added: the plain bf16 path is the yardstick, the largest error of
      ``MIXED_PLAIN_RUNS`` runs (its error carries the roundings of the
      linears' inputs and of the gradients to bf16, which its atomic sums
      move from run to run), plus
      one bf16 rounding of each gradient (2^-8 x its max |ref|), on which
      side of a tie the kernel path may land;
    - 1 + TRAIN_STEPS steps, captured (warm-up, recording, replays) against
      eager: values and every parameter, master, moment and count bitwise;
    - port launches per step: phase 12b's plus one Adam launch, at the
      eager steps, the warm-up and the recording; none at a replay;
    - ms per step captured (median of 5) against the float32 captured
      session's in the same call; device ms per replay (torch.profiler, 10
      replays), the Adam kernel's and the dtype casts' share of it, beside
      the float32 step's fused Adam; peak device memory over the steps.
    Then the CLI under (b) on the synthetic GASFM conf (phase 15's
    ``cli_run``: replays, learning, the tree), its weight file (bf16
    leaves) loaded back into a bf16 model. Returns the launches of the (a)
    run (the path the kernels line reports the Adam kernel's launches on)."""
    import copy

    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.main import init_model
    from gasfm_tpu_torch.ops.kernels import adam as A
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.train.state import load_params

    t_phase = time.perf_counter()
    conf_name = "gasfm/optim_euc_gasfm.conf"
    scene = scenes["dense"]
    counters = dict(counters, adam_update=A.adam_update)
    model0, n_params = init_model(load_config(conf_name))
    shapes = [tuple(p.shape) for p in model0.parameters() if p.requires_grad]
    kern = adam_kernel_phase(dev, shapes, record)
    per_step = {k: v for k, v in per_step_launches(L, backward=True).items() if v}
    fwd_bwd = dict(per_step)
    per_call = dict(per_step, **{k: per_step.get(k, 0) + v for k, v in REPRO_LAUNCHES.items()})
    with_adam = dict(per_call, adam_update=1)

    def session(ext, capture):
        conf = load_config(conf_name, external_params=list(ext))
        return TrainingSession.from_conf(conf, copy.deepcopy(model0), device=dev,
                                         capture=capture)

    def counted(fn):
        before = {k: c.launches for k, c in counters.items()}
        res = fn()
        return res, {k: c.launches - before[k] for k, c in counters.items()
                     if c.launches != before[k]}

    def profiled(sess, reps=10):
        """Device ms per replayed step from torch.profiler over ``reps``
        replays: (total, Adam's kernel, the dtype casts, {kernel: ms})."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):  # the profiler drops a window's events now and then (PERF.md)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    sess.fused_step(scene)
                torch.cuda.synchronize()
            by = collections.Counter()
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                if t:
                    by[e.key] += t / 1e3 / reps
            total = sum(by.values())
            if total > 0:
                break
        else:
            raise SmokeFailure("the profiler caught no device time in 3 windows")
        adam = sum(v for k, v in by.items() if "adam_kernel" in k or "FusedAdamMathFunctor" in k)
        casts = sum(v for k, v in by.items() if "copy_kernel" in k)
        return total, adam, casts, by

    def timed_ms(sess, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.fused_step(scene)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    # the float32 session: its step-1 loss and gradients, and its captured step
    ref_loss, _, ref_grads = session((), capture=False).loss_and_grads(scene)
    ref_loss = float(ref_loss)
    base = session((), capture=True)
    for _ in range(2):
        base.fused_step(scene)  # warm-up, recording
    f32_ms = timed_ms(base)
    f32_prof = profiled(base)
    print(f"mixed f32: the float32 flagship's captured dense step {f32_ms:.3f} ms; device "
          f"{f32_prof[0]:.3f} ms per replay (torch.profiler, 10 replays), fused Adam "
          f"{f32_prof[1]:.4f}, dtype casts {f32_prof[2]:.4f}")
    del base
    gc.collect()
    torch.cuda.empty_cache()

    results, path_launches = {}, None
    for label, ext in MIXED_RUNS:
        eager, cap = session(ext, capture=False), session(ext, capture=True)
        names = [k for k, p in eager.model.named_parameters() if p.requires_grad]
        if label == "a":
            for c in counters.values():
                c.launches = 0
        (loss, pred, grads), d = counted(lambda: eager.loss_and_grads(scene))
        if d != fwd_bwd:
            raise SmokeFailure(f"mixed {label}: loss_and_grads launched {d}, expected {fwd_bwd}")
        loss = float(loss)
        if label == "b":
            if abs(loss - ref_loss) > 1e-2 * abs(ref_loss):
                raise SmokeFailure(f"mixed b: step-1 loss {loss!r} vs float32 {ref_loss!r}")
            grad_note = mixed_grads_vs_float64(dev, eager, scene, pred, grads, names, record)
        else:
            same = loss == ref_loss and all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
            if not same:
                raise SmokeFailure(f"mixed {label}: step-1 loss {loss!r} / gradients differ from "
                                   f"the float32 session's ({ref_loss!r}); bitwise required")
            grad_note = "step-1 loss and gradients bitwise the float32 session's"
        del grads, pred
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)  # the steps' peak, the checks' apart
        steps, launches = [], []
        for k in range(1 + TRAIN_STEPS):
            e, de = counted(lambda: [float(v) for v in eager.fused_step(scene)])
            c, dc = counted(lambda: [float(v) for v in cap.fused_step(scene)])
            want_c = with_adam if k < 2 else {}
            if de != with_adam or dc != want_c:
                raise SmokeFailure(f"mixed {label}: step {k + 1} launches eager {de}, captured "
                                   f"{dc}; expected {with_adam} and {want_c}")
            launches.append(sum(dc.values()))
            ob, cb = eager.optimizer.buffers, cap.optimizer.buffers
            tensors = list(zip(eager.params, cap.params)) + [
                (x, y) for name in ("params", "mu", "nu")
                for x, y in zip(getattr(ob, name), getattr(cb, name))] + [(ob.count, cb.count)]
            if e != c or not all(torch.equal(x, y) for x, y in tensors):
                raise SmokeFailure(f"mixed {label}: step {k + 1} captured {c} vs eager {e}; "
                                   f"bitwise required")
            if not all(map(math.isfinite, c)):
                raise SmokeFailure(f"mixed {label}: step {k + 1} values {c}")
            steps.append(c)
        if label == "a":
            path_launches = {k: c.launches for k, c in counters.items()}
        if int(cap.optimizer.buffers.count) != 1 + TRAIN_STEPS:
            raise SmokeFailure(f"mixed {label}: Adam's count {int(cap.optimizer.buffers.count)}")
        master = cap.optimizer.buffers.master
        if master and not all(torch.equal(p, m.to(torch.bfloat16)) for p, m in
                              zip(cap.params, cap.optimizer.buffers.params)):
            raise SmokeFailure(f"mixed {label}: a bf16 weight is not its master's rounding")
        ms = timed_ms(cap)
        peak = torch.cuda.max_memory_allocated(dev)
        dev_ms, adam_ms, cast_ms, by = profiled(cap)
        results[label] = dict(external_params=list(ext), step1_loss=loss, steps=steps,
                              launches_per_call=launches, ms_captured=ms, ms_f32_captured=f32_ms,
                              peak_bytes=peak, grads=grad_note, device_ms=dev_ms,
                              adam_device_ms=adam_ms, cast_device_ms=cast_ms,
                              f32_device_ms=f32_prof[0], f32_adam_device_ms=f32_prof[1],
                              top_kernels=by.most_common(12))
        print(f"mixed {label} ({' '.join(ext)}): flagship dense, {n_params} parameters; step-1 "
              f"loss {loss!r} (float32 {ref_loss!r}); {grad_note}; {1 + TRAIN_STEPS} steps "
              f"captured vs eager bitwise (values, weights, "
              f"{'master, ' if master else ''}moments, count) {steps}; port launches per "
              f"captured call {launches} ({sum(with_adam.values())} = phase 12b's "
              f"{sum(per_call.values())} + 1 Adam, at the warm-up and the recording); captured "
              f"ms/step {ms:.3f} against float32's {f32_ms:.3f} ({ms / f32_ms:.3f}x); device ms "
              f"per replay {dev_ms:.3f} (float32 {f32_prof[0]:.3f}), the Adam kernel "
              f"{adam_ms:.4f} of it (fused f32 Adam {f32_prof[1]:.4f}), dtype casts {cast_ms:.4f}; "
              f"peak device memory over the steps {peak / 2**20:.1f} MiB (an eager and a "
              f"captured session) ok")
        del eager, cap
        gc.collect()
        torch.cuda.empty_cache()
    del ref_grads

    # the CLI under (b), its weight file loaded back
    out_dir = ROOT / "chiprun_out" / "phase17"
    out_dir.mkdir(parents=True, exist_ok=True)
    synth = "synth/optim_synth_gasfm.conf"
    b_ext = ("train.n_epochs=20", "eval.eval_interval=10") + MIXED_RUNS[1][1]
    summary = cli_run("synth-gasfm-bf16", synth, b_ext, counters, record, out_dir)
    first = summary["launches_first_steps"][0]
    if first.get("adam_update") != 1:
        raise SmokeFailure(f"CLI synth-gasfm-bf16: the warm-up step launched {first}")
    weights = out_dir / "synth-gasfm-bf16" / "OPTIMIZATION" / "synth0" / "models" / \
        "final_model.npz"
    import numpy as np

    with np.load(weights) as data:
        leaves = {k: data[k].dtype.str for k in data.files}
    if set(leaves.values()) != {"|V2"}:
        raise SmokeFailure(f"CLI synth-gasfm-bf16: weight file leaves {set(leaves.values())}")
    loaded = init_model(load_config(synth, external_params=list(b_ext)))[0].to(torch.bfloat16)
    load_params(str(weights), loaded)
    if not all(bool(torch.isfinite(p.float()).all()) for p in loaded.parameters()):
        raise SmokeFailure("CLI synth-gasfm-bf16: non-finite loaded weights")
    print(f"phase 17: the CLI under (b) wrote {len(leaves)} bf16 leaves (|V2), loaded back into a "
          f"bf16 model ok")
    record["mixed"] = dict(results, adam=kern)
    record["mixed_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 17 (mixed precision): {record['mixed_phase_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return path_launches, kern


def mixed_grads_vs_float64(dev, eager, scene, pred, grads, names, record, label="mixed b",
                           plain_runs=MIXED_PLAIN_RUNS):
    """(b)'s step-1 gradients (bf16) against the plain path run in float64
    from the same bf16 weights, by phase 5's rule with bf16's rounding added
    and the largest error of ``plain_runs`` plain runs its yardstick (see
    :func:`mixed_precision_phase`); phase 20 holds bf16 streams by the same
    rule, the float64 run's streams float64 (unrounded). Returns the line's
    note."""
    import copy

    from gasfm_tpu_torch.train.loop import TrainingSession

    _, _, p_grads = eager.loss_and_grads(scene, plain=True)
    more = [eager.loss_and_grads(scene, plain=True)[2] for _ in range(plain_runs - 1)]
    ref_model = copy.deepcopy(eager.model).double()
    if getattr(ref_model, "stream_dtype", None) is not None:
        ref_model.stream_dtype = torch.float32  # float64 streams: no bf16 rounding
    ref = TrainingSession(ref_model, eager.loss_func, device=dev, capture=False)
    acts = ActivationBranches()
    with acts.watch("record"):
        eager.loss_and_grads(scene)
    scene64 = float64_scene(scene)
    with acts.watch("compare"):
        r_loss, r_pred, r_grads = ref.loss_and_grads(scene64, plain=True)
    tie, ties = branch_ties(ref, scene64, pred, r_pred, r_grads, acts)
    rounding = [BF16_EPS * float(r.abs().max()) for r in r_grads]
    errs, G = param_grad_errors(names, [g.float() for g in grads], p_grads, r_grads, GRAD_EPS64,
                                [t + b for t, b in zip(ties, rounding)], more)
    bad = [t for t in errs if not t[-1]]
    wk = max(errs, key=lambda t: t[1] / max(t[3], 1e-30))
    # where one plain run's error would bound the kernel path's most tightly
    tight = max(errs, key=lambda t: t[1] / (GRAD_FACTOR * t[4] + GRAD_RTOL64 * t[3]
                                            + GRAD_EPS64 * G))
    note = (f"step-1 gradients (bf16, {len(errs)} tensors, G = {G:.4g}) against float64 from the "
            f"same weights: worst relative to its max |ref| {wk[0]} kernel {wk[1]:.3e}, plain "
            f"{wk[2]:.3e} (the largest of {plain_runs} runs), max |ref| {wk[3]:.3e}; the "
            f"plain path's error moves run to run, {tight[4]:.3e} to {tight[2]:.3e} on "
            f"{tight[0]} (kernel path {tight[1]:.3e}); ties {tie['act_flips']} activations, "
            f"{tie['loss_flips']} loss edges; tol kernel err <= {GRAD_FACTOR:g} x plain err + "
            f"{GRAD_RTOL64:g} x max|ref| + {GRAD_EPS64:g} x G + ties + 2^-8 x max|ref| "
            f"{'ok' if not bad else 'FAIL'}")
    record.setdefault(label.replace(" ", "_") + "_grads", {}).update(
        errors=[t[:5] for t in errs], G=G, loss64=float(r_loss), ties=tie,
        plain_runs=plain_runs)
    if bad:
        raise SmokeFailure(f"{label}: step-1 gradients out of tolerance: "
                           f"{[t[:4] for t in bad[:8]]}")
    del ref, r_grads, r_pred, p_grads, more
    return note

# ---------------------------------------------------------------------------
# phase 18: multi-device training on a mesh of ranks that share the card
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 20: the JAX package's activation-memory options (bf16 edge streams,
# compile.stream_dtype; layer rematerialization, model.remat_layers)
# ---------------------------------------------------------------------------

# The six edge-tile kernels' bf16 forms: kernels-line name -> (the wrapper
# whose bf16_launches counts them, the training path whose run reports them)
BF16_FORMS = {
    "fused_frontend_bf16": ("fused_frontend", "gasfm-bf16"),
    "fused_frontend_bwd_bf16": ("fused_frontend_bwd", "gasfm-bf16"),
    "fused_layer_step_bf16": ("fused_layer_step", "gasfm-bf16"),
    "fused_layer_step_bwd_bf16": ("fused_layer_step_bwd", "gasfm-bf16"),
    "projection_update_bf16": ("projection_update", "gasfm-depth-bf16"),
    "projection_update_bwd_bf16": ("projection_update_bwd", "gasfm-depth-bf16"),
}


def bf16_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
    """(max |got - want|, within the bound, share of elements that differ) of
    outputs of which one or both are bf16: within one bf16 ulp of the larger
    magnitude plus the float32 kernels' tolerance (atol x scale + rtol x
    |want|: KERNEL_* forward, BWD_* backward); float32 pairs at that
    tolerance alone."""
    if got.shape != want.shape:
        return float("inf"), False, 1.0
    bf = got.dtype == torch.bfloat16 or want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        return float("inf"), False, 1.0
    err = (g - w).abs()
    bound = atol * max(1.0, float(w.abs().max())) + rtol * w.abs()
    if bf:
        big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        bound = bound + torch.exp2(torch.floor(torch.log2(big)) - 7)
    differ = float((err > 0).double().mean()) if err.numel() else 0.0
    return float(err.max()) if err.numel() else 0.0, bool((err <= bound).all()), differ


def bf16_form_check(results, record, scene_name, name, variant, kernel, plain, outs, io_bytes,
                    flops, f32_kernel=None, f32_io=None, main=False):
    """A bf16 form against its plain version on the same bf16 inputs
    (:func:`bf16_close`; a backward, ``name`` ending in ``_bwd``, at the
    backward checks' tolerance), launched twice, bitwise; per call ms (CUDA events)
    of both, and with ``main`` the device ms per launch (``torch.profiler``)
    of the bf16 form and of the f32 form on the same values upcast
    (``f32_kernel``, its float32 copies made before it is timed), each
    beside its bound (bf16 rows counted at 2 bytes)."""
    from gasfm_tpu_torch.tools.kernel_device_time import device_ms_per_call

    got, want = kernel(), plain()
    tol = (BWD_RTOL, BWD_ATOL) if name.endswith("_bwd") else (KERNEL_RTOL, KERNEL_ATOL)
    worst, ok, parts = 0.0, True, []
    for o, g, w in zip(outs, got, want):
        if g is None and w is None:
            continue
        e, good, differ = bf16_close(g, w, *tol)
        worst, ok = max(worst, e), ok and good
        parts.append(f"{o} {e:.3e}{'' if good else ' OUT'} ({100 * differ:.2f}% differ)")
    if not same_twice(kernel, got):
        ok = False
        parts.append("two launches differ")
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    b_ms, b_by = bound_ms(io_bytes, flops)
    line = (f"kernel {name}[{variant}] {scene_name}: {'ok' if ok else 'FAIL'}; "
            f"{'; '.join(parts)}; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by})")
    rec = dict(scene=scene_name, name=name, variant=variant, max_abs_err=worst, ok=ok, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    if main:
        dev_ms = device_ms_per_call(kernel, 20)[0]
        f32_ms = device_ms_per_call(f32_kernel, 20)[0]
        f32_bound = bound_ms(f32_io, flops)[0]
        line += (f"; device {dev_ms:.4f} ms per call against its bound {b_ms:.4f}, the f32 "
                 f"form {f32_ms:.4f} against {f32_bound:.4f}")
        rec.update(device_ms=dev_ms, f32_device_ms=f32_ms, f32_bound_ms=f32_bound)
    print(line, flush=True)
    record.setdefault("bf16_variants", []).append(rec)
    entry = results.setdefault(name, dict(max_abs_err=0.0, ok=True))
    entry["max_abs_err"] = max(entry["max_abs_err"], worst)
    entry["ok"] = entry["ok"] and ok
    if main:
        entry.update(rec)


def memory_kernel_phase(dev, graphs, record):
    """Phase 20 (a): the bf16 forms of #3, #4, #5, #6, #9 and #10 against
    their plain versions on the same bf16 inputs, on each of ``graphs``
    (the dense scene's numbers go to the kernels line): the layer step's
    interior form (#5; #6 from seeded cotangents), the frontend at the
    first layer's widths with a float32 stream and its e_norm stored bf16
    and at De = 32 on a bf16 stream (the layer step's backward recomputes
    its source rows so), both ways, and the projection update with skip2
    and res, both ways."""
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls
    from gasfm_tpu_torch.ops.kernels import fused_proj_update as fpu

    gen = torch.Generator(device=dev).manual_seed(2020)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

    def f32(args):
        return tuple(t.float() if isinstance(t, torch.Tensor) and t.dtype == bf else t
                     for t in args)

    results = {}
    for label, graph in graphs.items():
        E, n, m, D = graph.num_edges, graph.num_pts, graph.num_cams, 32
        main = label == "dense"
        csr = (graph.pt_ptr, graph.cam_ptr, graph.cam_perm)
        ids = (graph.pt_idx, graph.cam_idx)

        def check(*a, **k):
            bf16_form_check(results, record, label, *a, **k)

        # #5: the interior layer step's prologue on bf16 [en | skip2] and res
        en, skip2, res = (torch.relu(rnd(E, 32)).to(bf), separated_pairs(rnd, gen, dev, E).to(bf),
                          rnd(E, 32).to(bf))
        tables = (rnd(n, 32), rnd(m, 32), rnd(1, 32))
        ln = (1.0 + rnd(32, scale=0.2), rnd(32, scale=0.1))
        lin = (rnd(D, 32, scale=0.2), rnd(D, scale=0.1), rnd(D, 32, scale=0.2), rnd(D, scale=0.1))
        sa = (en, skip2, res, rnd(32, 34, scale=0.2), rnd(32, scale=0.1), *tables, *ln, *lin)
        io = nbytes(*sa, *ids) + E * 32 * (2 * 2 + 2 * 4)
        flops = E * (2 * 34 * 32 + 8 * 32 + 4 * 32 * D)
        sa32 = f32(sa)
        check("fused_layer_step", "interior", lambda: fls.layer_step_prologue(*sa, graph),
              lambda: fls.layer_step_prologue_plain(*sa, graph),
              ("e_l", "e_norm_next", "xl_p", "xl_c"), io, flops,
              lambda: fls.layer_step_prologue(*sa32, graph),
              nbytes(*sa32, *ids) + E * 32 * 4 * 4, main)
        # #6 from the forward's e_l and seeded cotangents
        e_l = fls.layer_step_prologue(*sa, graph)[0]
        ba = (en, skip2, sa[3], e_l, *ln, lin[0], lin[2], graph, rnd(E, D), rnd(E, D),
              rnd(E, 32).to(bf), rnd(E, 32).to(bf))
        ba32 = f32(ba)
        io = nbytes(*ba[:8], *ba[9:], *csr) + E * 2 * (32 + 32 + 2) + 4 * E * 32 * 3
        check("fused_layer_step_bwd", "interior", lambda: fls.fused_layer_step_bwd(*ba),
              lambda: fls.layer_step_bwd_plain(*ba),
              ("d en", "d skip2", "d res", "d w", "d b", "d ps", "d pv", "d ln_scale",
               "d ln_bias", "d wlp", "d blp", "d wlc", "d blc"), io,
              E * (4 * D * 32 + 4 * 34 * 32 + 40 * 32),
              lambda: fls.fused_layer_step_bwd(*ba32),
              nbytes(*ba32[:8], *ba32[9:], *csr) + E * 4 * (32 + 32 + 2 + 32 * 3), main)

        # #3: a float32 stream with its e_norm stored bf16 (the first layer,
        # De = 2) and a bf16 stream (De = 32)
        for variant, e, Dq, en_dtype, main_v in (
                ("De2_en_bf16", separated_pairs(rnd, gen, dev, E), 4, bf, False),
                ("De32_bf16", rnd(E, 32).to(bf), 32, None, main)):
            De = e.shape[1]
            pa = (e, 1.0 + rnd(De, scale=0.2), rnd(De, scale=0.1), rnd(Dq, De, scale=0.3),
                  rnd(Dq, scale=0.1), rnd(Dq, De, scale=0.3), rnd(Dq, scale=0.1))

            def plain(pa=pa):
                v, xp, xc = fda.frontend_prologue_plain(*pa)
                return v.to(bf), xp, xc

            pa32 = f32(pa)
            io = nbytes(*pa) + E * (2 * De + 4 * 2 * Dq)
            check("fused_frontend", variant,
                  lambda pa=pa, d=en_dtype: fda.frontend_prologue(*pa, en_dtype=d), plain,
                  ("e_norm", "xl_p", "xl_c"), io, E * (4.0 * De * Dq + 10 * De),
                  lambda pa32=pa32: fda.frontend_prologue(*pa32),
                  nbytes(*pa32) + E * 4 * (De + 2 * Dq), main_v)
            # #4 from seeded cotangents of xl_p, xl_c and the bf16 e_norm
            g = (rnd(E, Dq), rnd(E, Dq), rnd(E, De).to(bf))
            fb = (pa[0], pa[1], pa[2], pa[3], pa[5], *g)

            def plain_bwd(pa=pa, g=g):
                with torch.enable_grad():
                    leaves = [t.detach().requires_grad_() for t in pa]
                    v, xp, xc = fda.frontend_prologue_plain(*leaves)
                    d = torch.autograd.grad([xp, xc, v], leaves, [g[0], g[1], g[2].float()])
                return d[0], d[1], d[2], d[3], d[4], d[5], d[6]

            fb32 = f32(fb)
            io = nbytes(*fb) + nbytes(pa[0]) + 4 * (2 * Dq * (De + 1) + 2 * De)
            check("fused_frontend_bwd", variant, lambda fb=fb: fda.fused_frontend_bwd(*fb),
                  plain_bwd, ("d e", "d ln_scale", "d ln_bias", "d wlp", "d blp", "d wlc",
                              "d blc"), io, E * (8.0 * De * Dq + 20 * De),
                  lambda fb32=fb32: fda.fused_frontend_bwd(*fb32),
                  nbytes(*fb32) + nbytes(pa32[0]) + 4 * (2 * Dq * (De + 1) + 2 * De),
                  main_v)

        # #9, #10: the projection update with skip2 and res
        ua = (en, skip2, res, sa[3], sa[4], *tables, graph)
        ua32 = f32(ua)
        io = nbytes(*ua[:8], *ids) + 2 * E * 32
        check("projection_update", "skip2_res", lambda: (fpu.projection_update_forward(*ua),),
              lambda: (fpu.projection_update_plain(*ua),), ("e",), io, E * 2 * 34 * 32,
              lambda: (fpu.projection_update_forward(*ua32),),
              nbytes(*ua32[:8], *ids) + 4 * E * 32, main)
        gu = rnd(E, 32).to(bf)
        bu32 = f32((gu, en, skip2, sa[3]))

        def plain_ubwd():
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in ua[:8]]
                e = fpu.projection_update_plain(*leaves, graph)
                d = torch.autograd.grad([e], leaves, [gu])
            return d[0], d[1], d[3], d[4], d[5], d[6]

        io = nbytes(gu, en, skip2, sa[3], *csr) + E * 2 * (32 + 2) + 4 * (n + m + 35) * 32
        check("projection_update_bwd", "skip2_res",
              lambda: fpu.projection_update_bwd(gu, en, skip2, sa[3], graph), plain_ubwd,
              ("d en", "d skip2", "d w", "d b", "d ps", "d pv"), io, E * 4 * 34 * 32,
              lambda: fpu.projection_update_bwd(*bu32, graph),
              nbytes(*bu32, *csr) + E * 4 * 34 + 4 * (n + m + 35) * 32,
              main)
    bad = [k for k, r in results.items() if not r["ok"]]
    if bad:
        raise SmokeFailure(f"bf16 forms out of tolerance: {bad}")
    return results


MEMORY_CONF = "gasfm/optim_euc_gasfm.conf"
# (b)'s runs: bf16 streams, and the JAX README's fast configuration (bf16
# streams and both Adam moments in bf16)
MEMORY_RUNS = (("streams", ("compile.stream_dtype=bf16",)),
               ("fast", ("compile.stream_dtype=bf16", "train.adam_mu_dtype=bf16",
                         "train.adam_nu_dtype=bf16")))


def stored_step_launches(per_step):
    """A bf16-stream step's launches: ``per_step``'s, and one frontend
    prologue (#3, on the bf16 stream) more per layer step in the backward,
    which recomputes its source rows from the stored e_l (as the JAX
    package's backward kernel does, fused_layer_step.py:439-458)."""
    out = dict(per_step)
    out["fused_frontend"] = out.get("fused_frontend", 0) + per_step.get("fused_layer_step", 0)
    return out


@contextlib.contextmanager
def shift_overshoot():
    """The bf16-stream layer step's backward (``fused_layer_step.py``
    ``_StoredStep``) recomputes the attention logits from the stored e_l and
    shifts their softmax by the forward's max plus ``SHIFT_MARGIN``, with
    exp(min(l - shift, 0)): a logit past the forward's max by more than the
    margin would get a wrong weight. In this scope each of the step's dual
    core backward calls appends, per direction, the largest recomputed
    logit less the forward's max (plain PyTorch beside the kernel; the
    kernel's launches and operands unchanged). Yields that list."""
    from gasfm_tpu_torch.ops.gatv2 import leaky_relu
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls

    orig, seen = fls.fused_dual_attend_bwd, []

    def watched(xl_p, xl_c, xr_p, xr_c, att_p, att_c, out_p, out_c, m_p, den_p, m_c, den_c,
                g_p, g_c, graph, heads, slope):
        for xl, xr, att, m, ids in ((xl_p, xr_p, att_p, m_p, graph.pt_idx),
                                    (xl_c, xr_c, att_c, m_c, graph.cam_idx)):
            ids = ids.long()
            z = leaky_relu(xl + xr[ids], slope) * att.reshape(-1)
            logits = z.reshape(z.shape[0], heads, -1).sum(-1)
            seen.append(float((logits - (m - fls.SHIFT_MARGIN)[ids]).max()))
        return orig(xl_p, xl_c, xr_p, xr_c, att_p, att_c, out_p, out_c, m_p, den_p, m_c, den_c,
                    g_p, g_c, graph, heads, slope)

    fls.fused_dual_attend_bwd = watched
    try:
        yield seen
    finally:
        fls.fused_dual_attend_bwd = orig


def overshoot_note(session, scene, label):
    """One eager loss_and_grads of ``session`` under :func:`shift_overshoot`:
    the largest overshoot over its layer steps, raising past the margin."""
    from gasfm_tpu_torch.ops.kernels.fused_layer_step import SHIFT_MARGIN

    with shift_overshoot() as seen:
        session.loss_and_grads(scene)
    if not seen:
        raise SmokeFailure(f"{label}: no bf16 layer step's backward ran")
    worst = max(seen)
    if worst > SHIFT_MARGIN:
        raise SmokeFailure(f"{label}: a recomputed logit passes the forward's max by {worst:.4g}, "
                           f"more than the backward's shift margin {SHIFT_MARGIN:g}")
    return (f"recomputed logits at most {worst:.4g} above the forward's max over "
            f"{len(seen) // 2} layer steps (margin {SHIFT_MARGIN:g})")


def activation_peak(session, scene):
    """(peak bytes above what was allocated before, loss, grads) of an eager
    loss_and_grads: the step's activation memory."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, pred, grads = session.loss_and_grads(scene)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return peak, float(loss), grads, pred


def memory_options_phase(dev, scenes, counters, record, L):
    """Phase 20 (b)-(e): the JAX package's activation-memory options on the
    card, through ``TrainingSession.from_conf`` (the counters zeroed just
    before each run and read just after).
    (b) The flagship (``MEMORY_CONF``, full width) on the dense scene under
    ``compile.stream_dtype = bf16``, and under the JAX README's fast
    configuration (also bf16 Adam moments): step-1 gradients against the
    plain path in float64 (float32 streams) by phase 17 (b)'s rule, the
    plain bf16-stream path's largest error of MIXED_PLAIN_RUNS runs its
    yardstick (the fast run's bitwise the streams run's: the moments act
    from the first update on); 1 + TRAIN_STEPS steps captured against eager
    bitwise; launches per step phase 12b's (:func:`stored_step_launches`),
    every launch of the six kernels their bf16 form; the recomputed
    logits' overshoot (:func:`overshoot_note`); device ms per replay and
    the step's activation peak beside the float32 session's.
    (c) The depth flagship under bf16 streams on the dense scene: the same,
    its own launches (the only path to #9 / #10).
    (d) ``model.remat_layers`` on the flagship, power-law scene: step-1
    loss and gradients bitwise those without it, eager and captured; the
    launches per step; the activation peak with and without.
    (e) The single-scene CLI with both keys on the synthetic GASFM conf.
    Returns the bf16 forms' launches per path."""
    import copy

    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.losses import DEPTH_LOSS
    from gasfm_tpu_torch.main import init_model
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
    from gasfm_tpu_torch.ops.kernels import adam as A
    from gasfm_tpu_torch.tools.profile_forward import FLAGSHIP_DEPTH, train_step
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.train.state import FLAGSHIP_OPTIM

    t_phase = time.perf_counter()
    dense, power = scenes["dense"], scenes["powerlaw"]
    counters = dict(counters, adam_update=A.adam_update)
    model0, n_params = init_model(load_config(MEMORY_CONF))

    def session(ext, capture, model=None):
        conf = load_config(MEMORY_CONF, external_params=list(ext))
        if model is None:
            model = GraphAttnSfMNet.from_conf(conf)
            model.load_state_dict(model0.state_dict())
        return TrainingSession.from_conf(conf, model, device=dev, capture=capture)

    def zero():
        for c in counters.values():
            c.launches = 0
            if hasattr(c, "bf16_launches"):
                c.bf16_launches = 0

    def counted(fn):
        return counted_launches(counters, fn)

    def bf16_share():
        return {form: (counters[w].bf16_launches, counters[w].launches)
                for form, (w, _) in BF16_FORMS.items() if counters[w].launches}

    def profiled_ms(sess, scene, reps=10):
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):  # the profiler drops a window's events now and then
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    train_step(sess, scene)
                torch.cuda.synchronize()
            total = sum((getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
                        for e in prof.key_averages()) / 1e3 / reps
            if total > 0:
                return total
        raise SmokeFailure("the profiler caught no device time in 3 windows")

    def steps_side_by_side(label, eager, cap, scene, want):
        """1 + TRAIN_STEPS steps captured against eager, bitwise (values and
        every parameter); ``want`` launches at each eager step, the warm-up
        and the recording, none at a replay."""
        steps = []
        for k in range(1 + TRAIN_STEPS):
            e, de = counted(lambda: [float(v) for v in train_step(eager, scene)])
            c, dc = counted(lambda: [float(v) for v in train_step(cap, scene)])
            want_c = want if k < 2 else {}
            if de != want or dc != want_c:
                raise SmokeFailure(f"{label}: step {k + 1} launches eager {de}, captured {dc}; "
                                   f"expected {want} and {want_c}")
            if e != c or not all(torch.equal(x, y) for x, y in zip(eager.params, cap.params)):
                raise SmokeFailure(f"{label}: step {k + 1} captured {c} vs eager {e}; bitwise "
                                   f"required")
            if not all(map(math.isfinite, c)):
                raise SmokeFailure(f"{label}: step {k + 1} values {c}")
            steps.append(c)
        return steps

    out = {}
    per_step = {k: v for k, v in per_step_launches(L, backward=True).items() if v}
    per_call = dict(per_step, **{k: per_step.get(k, 0) + v for k, v in REPRO_LAUNCHES.items()})
    # ---- the float32 session: its activation peak and device ms per replay
    f32_peak = activation_peak(session((), False), dense)[0]
    base = session((), True)
    for _ in range(2):
        train_step(base, dense)  # warm-up, recording
    f32_ms = profiled_ms(base, dense)
    del base
    print(f"memory f32: the float32 flagship (dense scene) step's activation peak "
          f"{f32_peak / 2**20:.1f} MiB, {f32_ms:.3f} device ms per replay", flush=True)

    # ---- (b) bf16 streams, then the fast configuration
    bf_fwd_bwd = stored_step_launches(per_step)
    bf_call = stored_step_launches(per_call)
    first_grads = None
    for label, ext in MEMORY_RUNS:
        eager, cap = session(ext, False), session(ext, True)
        names = [k for k, p in eager.model.named_parameters() if p.requires_grad]
        zero()
        (peak, loss, grads, pred), d = counted(lambda: activation_peak(eager, dense))
        if d != bf_fwd_bwd:
            raise SmokeFailure(f"memory {label}: loss_and_grads launched {d}, expected "
                               f"{bf_fwd_bwd}")
        share = bf16_share()
        if any(b != n for b, n in share.values()) or set(share) != {
                k for k, (_, path) in BF16_FORMS.items() if path == "gasfm-bf16"}:
            raise SmokeFailure(f"memory {label}: bf16 launches of the six {share}")
        if label == "streams":
            out["gasfm-bf16"] = {k: b for k, (b, _) in share.items()}
            note = mixed_grads_vs_float64(dev, eager, dense, pred, grads, names, record,
                                          label="memory streams")
            note += "; " + overshoot_note(eager, dense, "memory streams")
            first_grads = (loss, [g.clone() for g in grads])
        else:
            if loss != first_grads[0] or not all(torch.equal(a, b)
                                                  for a, b in zip(grads, first_grads[1])):
                raise SmokeFailure(f"memory {label}: step-1 loss / gradients differ from the "
                                   f"streams run's")
            note = "step-1 loss and gradients bitwise the streams run's"
        del grads, pred
        want = dict(bf_call, **({"adam_update": 1} if label == "fast" else {}))
        steps = steps_side_by_side(f"memory {label}", eager, cap, dense, want)
        ms = profiled_ms(cap, dense)
        record.setdefault("memory", {})[label] = dict(
            external_params=list(ext), step1_loss=loss, steps=steps, peak_bytes=peak,
            f32_peak_bytes=f32_peak, device_ms=ms, f32_device_ms=f32_ms, grads=note,
            launches_per_step=want)
        print(f"memory {label} ({' '.join(ext)}): flagship dense, {n_params} parameters; step-1 "
              f"loss {loss!r}; {note}; {1 + TRAIN_STEPS} steps captured vs eager bitwise {steps}; "
              f"port launches per step {sum(want.values())} (phase 12b's "
              f"{sum(per_call.values())} + {L} frontend prologues recomputing the layer steps' "
              f"source rows{' + 1 Adam' if label == 'fast' else ''}), the six kernels' launches "
              f"all bf16 forms {share}; activation peak {peak / 2**20:.1f} MiB (float32 "
              f"{f32_peak / 2**20:.1f}, {peak / f32_peak:.3f}x); {ms:.3f} device ms per replay "
              f"(float32 {f32_ms:.3f}) ok", flush=True)
        del eager, cap
        gc.collect()
        torch.cuda.empty_cache()

    # ---- (c) the depth flagship under bf16 streams
    Ld = len(model0.equivariant_blocks)
    depth_want = stored_step_launches({k: v for k, v in depth_step_launches(Ld, True).items()
                                       if v})

    def depth_session(stream_dtype, capture):
        model = GraphAttnSfMNet(**FLAGSHIP_DEPTH, stream_dtype=stream_dtype,
                                generator=torch.Generator().manual_seed(DEPTH_SEEDS["gasfm"]))
        return TrainingSession(model, make_loss(DEPTH_LOSS), device=dev, optim=FLAGSHIP_OPTIM,
                               capture=capture)

    d_f32_peak = activation_peak(depth_session(torch.float32, False), dense)[0]
    eager, cap = depth_session(torch.bfloat16, False), depth_session(torch.bfloat16, True)
    names = [k for k, p in eager.model.named_parameters() if p.requires_grad]
    zero()
    if not depth_want.get("fused_frontend"):
        raise SmokeFailure(f"memory depth: launches {depth_want}")
    (peak, loss, grads, pred), d = counted(lambda: activation_peak(eager, dense))
    if d != depth_want:
        raise SmokeFailure(f"memory depth: loss_and_grads launched {d}, expected {depth_want}")
    share = bf16_share()
    out["gasfm-depth-bf16"] = {k: b for k, (b, _) in share.items()}
    note = mixed_grads_vs_float64(dev, eager, dense, pred, grads, names, record,
                                  label="memory depth", plain_runs=DEPTH_PLAIN_RUNS)
    note += "; " + overshoot_note(eager, dense, "memory depth")
    del grads, pred
    steps = steps_side_by_side("memory depth", eager, cap, dense, depth_want)
    ms = profiled_ms(cap, dense)
    record.setdefault("memory", {})["depth"] = dict(step1_loss=loss, steps=steps, peak_bytes=peak,
                                                    f32_peak_bytes=d_f32_peak, device_ms=ms,
                                                    grads=note, launches_per_step=depth_want)
    print(f"memory depth: the depth flagship under bf16 streams, dense scene; step-1 loss "
          f"{loss!r}; {note}; {1 + TRAIN_STEPS} steps captured vs eager bitwise {steps}; launches "
          f"per step {sum(depth_want.values())} {depth_want} (bf16 forms of the six: {share}; "
          f"the widening last layer's frontend runs on the float32 stream); activation peak "
          f"{peak / 2**20:.1f} MiB (float32 {d_f32_peak / 2**20:.1f}); {ms:.3f} device ms per "
          f"replay ok", flush=True)
    del eager, cap
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) model.remat_layers on the flagship, power-law scene
    remat = {}
    for key, ext in (("plain", ()), ("remat", ("model.remat_layers=true",))):
        zero()
        (peak, loss, grads, _), d = counted(lambda: activation_peak(session(ext, False), power))
        remat[key] = (peak, loss, [g.clone() for g in grads], d)
        del grads
    (p0, l0, g0, d0), (p1, l1, g1, d1) = remat["plain"], remat["remat"]
    if l0 != l1 or not all(torch.equal(a, b) for a, b in zip(g0, g1)):
        worst = max(float((a - b).abs().max()) for a, b in zip(g0, g1))
        raise SmokeFailure(f"memory remat: step-1 loss {l1!r} vs {l0!r}, gradients differ by up "
                           f"to {worst:.3e}; bitwise required")
    eager, cap = session(("model.remat_layers=true",), False), session(
        ("model.remat_layers=true",), True)
    steps = steps_side_by_side("memory remat", eager, cap, power,
                               dict(d1, **{k: d1.get(k, 0) + v for k, v in REPRO_LAUNCHES.items()}))
    del eager, cap
    record.setdefault("memory", {})["remat"] = dict(peak_bytes=p1, plain_peak_bytes=p0,
                                                    launches=d1, plain_launches=d0, steps=steps)
    print(f"memory remat: the flagship on the power-law scene with model.remat_layers: step-1 loss "
          f"and {len(g0)} gradients bitwise those without it; {1 + TRAIN_STEPS} steps captured vs "
          f"eager bitwise {steps}; launches per loss_and_grads {sum(d1.values())} {d1} (without: "
          f"{sum(d0.values())}); activation peak {p1 / 2**20:.1f} MiB against "
          f"{p0 / 2**20:.1f} without ({p1 / p0:.3f}x) ok", flush=True)
    del g0, g1
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) the single-scene CLI with both keys
    out_dir = ROOT / "chiprun_out" / "phase20"
    out_dir.mkdir(parents=True, exist_ok=True)
    cli_run("synth-gasfm-memory", "synth/optim_synth_gasfm.conf",
            ("train.n_epochs=20", "eval.eval_interval=10", "compile.stream_dtype=bf16",
             "model.remat_layers=true"), counters, record, out_dir)
    record["memory_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 20 (memory options): {record['memory_phase_s']:.1f} s", flush=True)
    return out


def kernel_counters():
    """The port's kernel wrappers whose launches the phases count, by name."""
    from gasfm_tpu_torch.ops.kernels import fused_attn as fat
    from gasfm_tpu_torch.ops.kernels import fused_dual_attn as fda
    from gasfm_tpu_torch.ops.kernels import fused_layer_step as fls
    from gasfm_tpu_torch.ops.kernels import fused_loss as flo
    from gasfm_tpu_torch.ops.kernels import fused_proj_update as fpu
    from gasfm_tpu_torch.ops.kernels import fused_update as fu
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    return {"fused_dual_attend": fda.fused_dual_attend,
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


# A mesh run: (label, mesh, model ("gasfm" | "dpesfm", widths and seed), loss
# ("esfm" | "depth", its keyword arguments), optimizer preset, the group's
# scenes ("name" or "name:seed", a bench scene of profile_forward.SCENES),
# how the first step runs ("grads": group_loss_and_grads + update, its loss
# and gradients compared; "fused": fused_group_step), the steps, whether rank
# 0 returns its first gradients and times the gradient all-reduce alone, the
# session's table_sharding (None: on with more than one edge shard, the
# default; False: replicated tables)).
MeshRun = collections.namedtuple(
    "MeshRun", "label mesh model loss optim scenes first steps grads ts", defaults=(None,))
FLAGSHIP_REPLICATED = "flagship [1, 2] replicated"
FLAGSHIP_SHARDED = "flagship [1, 2] table-sharded"


def mesh_runs():
    from gasfm_tpu_torch.losses import DEPTH_LOSS, DPESFM_LOSS, FLAGSHIP_LOSS
    from gasfm_tpu_torch.tools.profile_forward import DPESFM, FLAGSHIP, FLAGSHIP_DEPTH

    two, depth3 = dict(FLAGSHIP, num_layers=2), dict(FLAGSHIP_DEPTH, num_layers=3)
    return (
        # the flagship, 9 layers at full width, on the dense scene: over
        # replicated tables, then table-sharded (the default), held against it
        MeshRun(FLAGSHIP_REPLICATED, (1, 2), ("gasfm", FLAGSHIP, 0), ("esfm", FLAGSHIP_LOSS),
                "flagship", ("dense",), "grads", 1 + MESH_STEPS, True, False),
        MeshRun(FLAGSHIP_SHARDED, (1, 2), ("gasfm", FLAGSHIP, 0), ("esfm", FLAGSHIP_LOSS),
                "flagship", ("dense",), "grads", 1 + MESH_STEPS, True),
        # the unfused path (the wide scene: #13/#14, table-sharded its
        # exchange) and the depth flagship (3 layers: the least that reaches
        # the projection update), over replicated tables and table-sharded;
        # DPESFM table-sharded (the point table's sum alone)
        MeshRun("wide [1, 2] replicated", (1, 2), ("gasfm", two, 0), ("esfm", FLAGSHIP_LOSS),
                "flagship", ("wide",), "grads", 2, True, False),
        MeshRun("wide [1, 2]", (1, 2), ("gasfm", two, 0), ("esfm", FLAGSHIP_LOSS), "flagship",
                ("wide",), "grads", 2, True),
        MeshRun("depth [1, 2] replicated", (1, 2), ("gasfm", depth3, DEPTH_SEEDS["gasfm"]),
                ("depth", DEPTH_LOSS), "flagship", ("dense",), "grads", 2, True, False),
        MeshRun("depth [1, 2]", (1, 2), ("gasfm", depth3, DEPTH_SEEDS["gasfm"]),
                ("depth", DEPTH_LOSS), "flagship", ("dense",), "grads", 2, True),
        MeshRun("dpesfm [1, 2]", (1, 2), ("dpesfm", DPESFM, 0), ("esfm", DPESFM_LOSS),
                "dpesfm", ("powerlaw",), "grads", 2, True),
        # DPESFM, scene data parallelism: a group of two, a padded group of one
        MeshRun("dpesfm group [2, 1]", (2, 1), ("dpesfm", DPESFM, 0), ("esfm", DPESFM_LOSS),
                "dpesfm", ("powerlaw", "powerlaw:1"), "grads", 2, True),
        MeshRun("dpesfm padded [2, 1]", (2, 1), ("dpesfm", DPESFM, 0), ("esfm", DPESFM_LOSS),
                "dpesfm", ("powerlaw",), "fused", 1, False),
        # 4 ranks, GASFM at 2 layers: four edge shards, table-sharded (the two
        # middle ones with neighbours on both sides), and both axes at once,
        # over replicated tables and table-sharded
        MeshRun("gasfm [1, 4]", (1, 4), ("gasfm", two, 0), ("esfm", FLAGSHIP_LOSS), "flagship",
                ("dense",), "grads", 2, True),
        MeshRun("gasfm [2, 2] replicated", (2, 2), ("gasfm", two, 0), ("esfm", FLAGSHIP_LOSS),
                "flagship", ("dense", "powerlaw"), "fused", 1, False, False),
        MeshRun("gasfm [2, 2]", (2, 2), ("gasfm", two, 0), ("esfm", FLAGSHIP_LOSS), "flagship",
                ("dense", "powerlaw"), "fused", 1, False),
    )


MESH_STEPS = 3  # the steps after the first of the flagship's runs


def mesh_scene_data(name, depth):
    """The SceneData of a bench scene, ``name`` or ``name:seed``."""
    from gasfm_tpu_torch.data.scene import SceneData
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.tools.profile_forward import SCENES

    base, _, seed = name.partition(":")
    kw = dict(SCENES[base], **({"seed": int(seed)} if seed else {}))
    data = generate_synthetic_scene(**kw)
    return SceneData(data.M, data.Ns, data.y, name, calibrated=True, store_depth_targets=depth)


def mesh_model(spec):
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
    from gasfm_tpu_torch.models.set_of_set import SetOfSetNet

    kind, widths, seed = spec
    cls = GraphAttnSfMNet if kind == "gasfm" else SetOfSetNet
    return cls(**widths, generator=torch.Generator().manual_seed(seed))


def mesh_session(run, device, mesh=None):
    from gasfm_tpu_torch.losses import DirectDepthLoss, ESFMLoss
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.train.state import DPESFM_OPTIM, FLAGSHIP_OPTIM

    loss = (ESFMLoss if run.loss[0] == "esfm" else DirectDepthLoss)(**run.loss[1])
    optim = FLAGSHIP_OPTIM if run.optim == "flagship" else DPESFM_OPTIM
    return TrainingSession(mesh_model(run.model), loss, device=device, optim=optim,
                           capture=False, mesh=mesh, table_sharding=run.ts)


def first_moments(session):
    """Adam's first moment of each parameter: after the first update 0.1 x
    its gradient (neither optimizer preset clips), the gradient a fused
    step applied."""
    state = session.optimizer.adam.state
    return [state[p]["exp_avg"] for p in session.params]


def weights_digest(model) -> str:
    import hashlib

    flat = torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def mesh_rank(mesh, runs):
    """One rank of phase 18 (``parallel.run_ranks``' function): each run of
    this mesh from fresh weights, eagerly, every step timed between two
    synchronisations with its launches counted (the counters zeroed just
    before it, read just after); after each update a digest of the
    weights; rank 0 returns the first step's gradients (through Adam's
    first moment after a fused one) and, with whole scenes per rank, the
    weights after it. Each step also counts the all-reduces over the edge
    group, the bytes they carry and the host ms they take, the card
    synchronised before each (``torch.distributed.all_reduce`` wrapped here:
    the gradient sum goes over the world, the loss's over the data group)."""
    import torch.distributed as dist

    from gasfm_tpu_torch.parallel import make_mesh

    counters = kernel_counters()
    out = dict(rank=mesh.rank, backend=dist.get_backend(), device=str(mesh.device),
               name=torch.cuda.get_device_name(mesh.device), runs={})
    meshes = {(mesh.n_data, mesh.n_edge): mesh}
    edge = {"group": None, "calls": 0, "bytes": 0, "s": 0.0}
    all_reduce = dist.all_reduce

    def counted_all_reduce(tensor, *args, **kw):
        group = kw.get("group", args[1] if len(args) > 1 else None)
        if group is None or group is not edge["group"]:
            return all_reduce(tensor, *args, **kw)
        edge["calls"] += 1
        edge["bytes"] += tensor.numel() * tensor.element_size()
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        out = all_reduce(tensor, *args, **kw)
        torch.cuda.synchronize(mesh.device)
        edge["s"] += time.perf_counter() - t0
        return out

    dist.all_reduce = counted_all_reduce
    for run in runs:
        t_setup = time.perf_counter()
        if run.mesh not in meshes:  # another layout of the same ranks ([2, 1] of [1, 2]'s)
            meshes[run.mesh] = make_mesh(*run.mesh, mesh.device)
        mesh = meshes[run.mesh]
        edge["group"] = mesh.edge_scope
        session = mesh_session(run, mesh.device, mesh)
        depth = run.loss[0] == "depth"
        # the group as the session takes it, only this rank's slot's scene made
        # (pad_scene_group: slot d takes scene d, or the last one past the group)
        mine = min(mesh.data_slot, len(run.scenes) - 1)
        graphs = [session.scene_graph(mesh_scene_data(s, depth)) if i == mine else None
                  for i, s in enumerate(run.scenes)]
        res = dict(values=[], ms=[], launches=[], digests=[], edge_calls=[], edge_bytes=[],
                   edge_ms=[],
                   setup_s=time.perf_counter() - t_setup, table_sharding=session.table_sharding,
                   table_shard=graphs[mine].graph.table_shard)
        if run.grads:  # the forward from the first weights, whole on every rank
            pred = session.forward(graphs[mine])
            if mesh.rank == 0:
                res["pred0"] = {k: v.cpu() for k, v in pred.items()}
        for k in range(run.steps):
            for fn in counters.values():
                fn.launches = 0
            edge.update(calls=0, bytes=0, s=0.0)
            torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            if k == 0 and run.first == "grads" or depth:
                loss, _, grads = session.group_loss_and_grads(graphs)
                values = [float(loss), float(session.update(grads))]
            else:
                values = [float(v) for v in session.fused_group_step(graphs)]
            torch.cuda.synchronize(mesh.device)
            res["ms"].append(1e3 * (time.perf_counter() - t0))
            res["edge_calls"].append(edge["calls"])
            res["edge_bytes"].append(edge["bytes"])
            res["edge_ms"].append(1e3 * edge["s"])
            res["launches"].append({n: fn.launches for n, fn in counters.items() if fn.launches})
            res["values"].append(values)
            res["digests"].append(weights_digest(session.model))
            if k == 0 and run.first == "grads" and run.grads:
                bufs = [g.clone() for g in grads]
                torch.cuda.synchronize(mesh.device)
                t0 = time.perf_counter()
                mesh.sum_over_world(bufs)
                torch.cuda.synchronize(mesh.device)
                res["allreduce_ms"] = 1e3 * (time.perf_counter() - t0)
                res["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
                del bufs
                if mesh.rank == 0:
                    res["grads"] = [g.cpu() for g in grads]
            if k == 0 and run.first == "fused" and mesh.rank == 0:
                res["mu"] = [m.cpu() for m in first_moments(session)]
            if k == 0 and mesh.rank == 0 and mesh.n_edge == 1:  # whole scenes per rank
                res["weights1"] = [p.detach().cpu() for p in session.params]
        out["runs"][run.label] = res
        session.close()
        del session, graphs
        gc.collect()
        torch.cuda.empty_cache()
    dist.all_reduce = all_reduce
    return out


def mesh_grad_errors(got, ref, scale_rule):
    """Per tensor (index, max |err|, max |ref|, allowed) of ``got`` against
    ``ref`` (lists of tensors), ``scale_rule(k, max |ref|)`` the allowance."""
    out = []
    for k, (g, r) in enumerate(zip(got, ref)):
        r = r.to(g.device, torch.float64)
        err = float((g.double() - r).abs().max())
        scale = float(r.abs().max())
        out.append((k, err, scale, scale_rule(k, scale), bool(torch.isfinite(g).all())))
    return out


def flagship_grad_rule(record, names):
    """Phase 5's rule for the flagship's step-1 gradients on the dense
    scene, per tensor, taken twice (two paths, each against float64), plus
    its ties' most: ``allowed(k, scale)`` for parameter ``names[k]``."""
    p5 = record["train"]["dense"]
    G = p5["step1_grad_G"]
    tie = record["train"].get("dense_ties", {}).get("most", 0.0)
    rule = {t[0]: GRAD_FACTOR * t[2] + GRAD_RTOL64 * t[3] + GRAD_EPS64 * G
            for t in p5["step1_grad_vs_float64"]}

    def allowed(k, scale):
        return 2 * rule[names[k]] + tie
    return allowed


def mesh_phase(dev, counters, record, L, graphs_by_name):
    """Phase 18: the (data, edge) mesh (``parallel.mesh_shape``; table
    sharding, the default with more than one edge shard, and replicated
    tables) with ranks that share the card, through ``parallel.run_ranks``
    and the mesh ``TrainingSession``, against the single-rank eager session
    on the card in this process from the same weights (on the bench scenes'
    graphs of ``graphs_by_name``, made at set-up; another scene is made
    here); the table-sharded flagship also against the replicated one; then
    the CLI: single-scene optimization under [1, 2] over replicated tables
    and table-sharded, multi-scene learning under [2, 1] and [1, 2]. Returns
    each run's ranks' results by label (phase 19's reference)."""
    from gasfm_tpu_torch.parallel import run_ranks

    t_phase = time.perf_counter()
    runs = mesh_runs()
    by_mesh = collections.defaultdict(list)  # one spawn per number of ranks
    for run in runs:
        by_mesh[(1, math.prod(run.mesh))].append(run)
    results = {}
    for shape, group in by_mesh.items():
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank, *shape, args=(group,), device="cuda")
        print(f"phase 18 {sorted({str(list(r.mesh)) for r in group})}: {len(ranks)} ranks "
              f"spawned, run and joined in "
              f"{time.perf_counter() - t0:.1f} s; " + "; ".join(
                  f"rank {r['rank']} {r['backend']} on {r['device']} ({r['name']})"
                  for r in ranks))
        for r in ranks:
            if r["backend"] != "gloo" or not r["device"].startswith("cuda"):
                raise SmokeFailure(f"phase 18: rank {r['rank']} on {r['backend']} {r['device']}")
        for run in group:
            results[run.label] = [r["runs"][run.label] for r in ranks]

    summary = {}
    for run in runs:
        ranks = results[run.label]
        r0 = ranks[0]
        # the same weights on every rank after every update
        for r in ranks[1:]:
            if r["digests"] != r0["digests"]:
                raise SmokeFailure(f"phase 18 {run.label}: weights differ between ranks")
        sharded = run.mesh[1] > 1 and run.ts is not False
        if any(r["table_sharding"] != sharded for r in ranks):
            raise SmokeFailure(f"phase 18 {run.label}: table sharding {r0['table_sharding']}, "
                               f"asked {sharded}")
        if sharded:
            print(f"phase 18 {run.label}: table-sharded, the ranks' boundary points (first, "
                  f"last, shared left, shared right) and owned points " + "; ".join(
                      f"rank {k}: ({t.first}, {t.last}, {t.shared_left}, {t.shared_right}) "
                      f"[{t.own_lo}, {t.own_hi})"
                      for k, t in enumerate(r["table_shard"] for r in ranks)))
        # the single-rank reference from the same weights: a group of one
        # through fused_step; else the group's scenes' loss_and_grads summed
        # (the JAX package's accumulate path), then update; each scene's
        # launches counted
        ref = mesh_session(run, dev)
        names = [k for k, p in ref.model.named_parameters() if p.requires_grad]
        graphs = [graphs_by_name[s] if s in graphs_by_name
                  else ref.scene_graph(mesh_scene_data(s, run.loss[0] == "depth"))
                  for s in run.scenes]
        if run.grads:  # the mesh's forward from the first weights against the single rank's
            want = ref.forward(graphs[0])
            errs = {k: max_err(r0["pred0"][k].to(dev), v, SLICE_RTOL, SLICE_ATOL)
                    for k, v in want.items()}
            print(f"phase 18 {run.label}: forward from the first weights, max |err| against the "
                  f"single rank's {({k: f'{e:.3e}' for k, (e, _) in errs.items()})} (tol "
                  f"{SLICE_ATOL:g} x scale + {SLICE_RTOL:g} x |ref|) "
                  f"{'ok' if all(ok for _, ok in errs.values()) else 'FAIL'}")
            if not all(ok for _, ok in errs.values()):
                raise SmokeFailure(f"phase 18 {run.label}: forward out of tolerance {errs}")
        if run.label == FLAGSHIP_SHARDED:
            # against the replicated tables' run: the forward, the first loss, and
            # fewer bytes through the edge group
            rep = results[FLAGSHIP_REPLICATED][0]
            errs = {k: max_err(r0["pred0"][k].to(dev), v.to(dev), SLICE_RTOL, SLICE_ATOL)
                    for k, v in rep["pred0"].items()}
            loss_rel = abs(r0["values"][0][0] - rep["values"][0][0]) / abs(rep["values"][0][0])
            print(f"phase 18 {run.label}: forward against the replicated run's, max |err| "
                  f"{({k: f'{e:.3e}' for k, (e, _) in errs.items()})}; step-1 loss "
                  f"{r0['values'][0][0]!r} against {rep['values'][0][0]!r} (rel {loss_rel:.2e}); "
                  f"through the edge group per step {r0['edge_calls'][-1]} all-reduces, "
                  f"{r0['edge_bytes'][-1]} bytes, {r0['edge_ms'][-1]:.1f} ms, against "
                  f"{rep['edge_calls'][-1]}, {rep['edge_bytes'][-1]} bytes, "
                  f"{rep['edge_ms'][-1]:.1f} ms; ms per step "
                  f"{[round(t, 1) for t in r0['ms']]} against {[round(t, 1) for t in rep['ms']]}")
            if not all(ok for _, ok in errs.values()) or loss_rel > 1e-5 or \
                    r0["edge_bytes"][-1] >= rep["edge_bytes"][-1]:
                raise SmokeFailure(f"phase 18 {run.label}: against the replicated run: forward "
                                   f"{errs}, loss rel {loss_rel}, edge bytes "
                                   f"{r0['edge_bytes'][-1]} / {rep['edge_bytes'][-1]}")
        fused_ref = run.first == "fused" and len(graphs) == 1
        if fused_ref:
            (loss, repro, norm), launches = counted_launches(
                counters, lambda: ref.fused_step(graphs[0]))
            total, repro, norm, grads = float(loss), float(repro), float(norm), None
            grads_launches = {k: v - REPRO_LAUNCHES.get(k, 0) for k, v in launches.items()}
            scene_launches = [{k: v for k, v in grads_launches.items() if v}]
        else:
            total, grads, repro, scene_launches = 0.0, None, 0.0, []
            for sg in graphs:
                (loss, pred, g), launches = counted_launches(counters,
                                                             lambda: ref.loss_and_grads(sg))
                scene_launches.append(launches)
                total += float(loss)
                if run.loss[0] == "esfm":
                    repro += float(ref.our_repro(pred, sg))
                grads = g if grads is None else ref.accumulate(grads, g)
            norm = float(ref.update(grads))
        ref_mu = [m.clone() for m in first_moments(ref)] if "mu" in r0 else None
        ref_params1 = [p.detach().clone() for p in ref.params] if "weights1" in r0 else None
        # the port's launches per rank per step: its slot's scene's in the
        # single-rank eager step (plus our_repro's gathers in a fused step)
        for rank, r in enumerate(ranks):
            slot = min(rank // run.mesh[1], len(graphs) - 1)
            for k, got in enumerate(r["launches"]):
                want = dict(scene_launches[slot])
                if not ((k == 0 and run.first == "grads") or run.loss[0] == "depth"):
                    for name, v in REPRO_LAUNCHES.items():
                        want[name] = want.get(name, 0) + v
                if got != want:
                    raise SmokeFailure(f"phase 18 {run.label}: rank {rank} step {k + 1} "
                                       f"launched {got}, the single-rank eager step {want}")
        first = r0["values"][0]
        info = dict(ms=r0["ms"], setup_s=r0["setup_s"], launches_per_step=r0["launches"][-1],
                    allreduce_ms=r0.get("allreduce_ms"), grad_bytes=r0.get("grad_bytes"),
                    table_sharding=sharded, edge_calls=r0["edge_calls"],
                    edge_bytes=r0["edge_bytes"], edge_ms=r0["edge_ms"])
        if run.first == "fused":
            loss_g, repro_g, n_valid, norm_g = first
            if n_valid != len(run.scenes) or abs(loss_g - total) > 1e-4 * abs(total) or \
                    abs(repro_g - repro) > 1e-4 * abs(repro) or abs(norm_g - norm) > 1e-3 * norm:
                raise SmokeFailure(
                    f"phase 18 {run.label}: (loss, our_repro, n_valid, grad_norm) {first} "
                    f"against the single-rank ({total}, {repro}, {len(run.scenes)}, {norm})")
            print(f"phase 18 {run.label}: (loss, our_repro, n_valid, grad_norm) {first} against "
                  f"the single-rank {'fused_step' if fused_ref else 'sum'} "
                  f"{[total, repro, len(run.scenes), norm]} ok")
            info["first"] = dict(mesh=first, single=[total, repro, len(run.scenes), norm])
        else:
            if abs(first[0] - total) > 1e-5 * abs(total):
                raise SmokeFailure(f"phase 18 {run.label}: step-1 loss {first[0]!r} against the "
                                   f"single-rank {total!r}")
            if run.label in (FLAGSHIP_REPLICATED, FLAGSHIP_SHARDED):
                allowed = flagship_grad_rule(record, names)
            else:
                G = max(float(g.abs().max()) for g in grads)

                def allowed(k, scale):
                    return 1e-4 * scale + MESH_GRAD_EPS * G
            errs = mesh_grad_errors(r0["grads"], grads, allowed)
            bad = [e for e in errs if e[1] > e[3] or not e[4]]
            worst = max(errs, key=lambda e: e[1] / max(e[3], 1e-30))
            print(f"phase 18 {run.label}: step-1 loss {first[0]!r} (single-rank {total!r}); "
                  f"{len(errs)} gradients against the single-rank eager step, the closest to "
                  f"its bound {names[worst[0]]}: max |err| {worst[1]:.3e}, allowed "
                  f"{worst[3]:.3e} (max |ref| {worst[2]:.3e}) {'ok' if not bad else 'FAIL'}")
            if bad:
                raise SmokeFailure(f"phase 18 {run.label}: gradients out of tolerance: "
                                   f"{[(names[e[0]], e[1], e[3]) for e in bad[:8]]}")
            info["grad_worst"] = (names[worst[0]], worst[1], worst[3])
        if ref_mu is not None:
            # a fused first step's gradients, through Adam's first moment:
            # bitwise the single rank's with whole scenes per rank, else by
            # the rule of the other runs' gradients
            if run.mesh[1] == 1:
                bad = [names[k] for k, (a, b) in enumerate(zip(r0["mu"], ref_mu))
                       if not torch.equal(a.to(dev), b)]
                worst = "bitwise equal" if not bad else f"differ: {bad[:8]}"
            else:
                G = max(float(m.abs().max()) for m in ref_mu)
                errs = mesh_grad_errors(r0["mu"], ref_mu,
                                        lambda k, scale: 1e-4 * scale + MESH_GRAD_EPS * G)
                bad = [(names[e[0]], e[1], e[3]) for e in errs if e[1] > e[3] or not e[4]]
                w = max(errs, key=lambda e: e[1] / max(e[3], 1e-30))
                worst = (f"the closest to its bound {names[w[0]]}: max |err| {w[1]:.3e}, "
                         f"allowed {w[3]:.3e} (max |ref| {w[2]:.3e})")
            print(f"phase 18 {run.label}: {len(ref_mu)} first moments after the first step "
                  f"(0.1 x its gradients) against the single rank's, {worst} "
                  f"{'ok' if not bad else 'FAIL'}")
            if bad:
                raise SmokeFailure(f"phase 18 {run.label}: first moments out of tolerance: "
                                   f"{bad[:8]}")
            info["mu_check"] = worst
        if "weights1" in r0:
            # scene data parallelism: the ranks' sum is the single rank's, and
            # so are the first update's weights, bitwise
            bad = [names[k] for k, (a, b) in enumerate(zip(r0["weights1"], ref_params1))
                   if not torch.equal(a.to(dev), b)]
            print(f"phase 18 {run.label}: weights after the first update bitwise the single "
                  f"rank's {'ok' if not bad else 'FAIL'}")
            if bad:
                raise SmokeFailure(f"phase 18 {run.label}: the first update's weights differ "
                                   f"from the single rank's: {bad[:8]}")
            info["weights1_bitwise"] = True
        # the later steps: their losses against the single-rank session's
        later = []
        for k in range(1, run.steps):
            if run.loss[0] == "depth" or len(graphs) > 1:
                total_k, grads_k = 0.0, None
                for sg in graphs:
                    loss, _, g = ref.loss_and_grads(sg)
                    total_k += float(loss)
                    grads_k = g if grads_k is None else ref.accumulate(grads_k, g)
                ref.update(grads_k)
                later.append(total_k)
            else:
                later.append(float(ref.fused_step(graphs[0])[0]))
        got_later = [v[0] for v in r0["values"][1:]]
        for a, b in zip(got_later, later):
            if not math.isfinite(a) or abs(a - b) > SLICE_RTOL * abs(b):
                raise SmokeFailure(f"phase 18 {run.label}: later losses {got_later} against the "
                                   f"single-rank {later}")
        info["later_losses"] = dict(mesh=got_later, single=later)
        steps_ms = [round(t, 1) for t in r0["ms"]]
        print(f"phase 18 {run.label}: weights equal on all {len(ranks)} ranks after each of "
              f"{run.steps} steps; ms per step {steps_ms}"
              f"{'' if r0.get('allreduce_ms') is None else f'; the gradient all-reduce alone ' + format(r0['allreduce_ms'], '.1f') + ' ms for ' + format(r0['grad_bytes'] / 2**20, '.1f') + ' MiB'}; "
              f"launches per rank per step {r0['launches'][-1]} (the single-rank eager step's); "
              f"through the edge group per step {r0['edge_calls'][-1]} all-reduces, "
              f"{r0['edge_bytes'][-1]} bytes, {r0['edge_ms'][-1]:.1f} ms; later losses "
              f"{got_later} (single-rank {later}) ok")
        summary[run.label] = info
        ref.close()
        del ref, graphs, grads
        gc.collect()
        torch.cuda.empty_cache()
    record["mesh"] = summary
    record["mesh"]["single_rank_eager_ms"] = record["train"]["dense"]["median_ms"]
    print(f"phase 18: the single-rank eager flagship step on the dense scene (phase 5, this "
          f"run) {record['train']['dense']['median_ms']:.3f} ms against the [1, 2] mesh's "
          f"{statistics.median(summary[FLAGSHIP_REPLICATED]['ms'][1:]):.3f} ms over replicated "
          f"tables, {statistics.median(summary[FLAGSHIP_SHARDED]['ms'][1:]):.3f} ms "
          f"table-sharded")
    for ts in (False, None):
        mesh_cli_run(ts, record)
    for shape in ("[2,1]", "[1,2]"):
        mesh_msl_run(shape, record)
    record["mesh_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 18 (multi-device training on a mesh of ranks): {record['mesh_phase_s']:.1f} s")
    return results


MESH_GRAD_EPS = 5e-6  # x the largest gradient: cancelling sums' noise, both float32 paths


def mesh_cli_run(ts, record):
    """``single-scene-optim`` under [1, 2] on the synthetic GASFM conf with
    ``parallel.table_sharding`` ``ts`` (False: replicated tables; None:
    unset, table-sharded): exit 0, one tree, a finite final our_repro. Into
    chiprun_out/phase18/ (emptied before the first)."""
    import os
    import shutil

    from gasfm_tpu_torch.main import main as cli_main

    name = "cli" if ts is None else "cli_replicated"
    kind = "table-sharded" if ts is None else "replicated tables"
    out_dir = ROOT / "chiprun_out" / "phase18"
    if ts is False and out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    before = os.environ.get("GASFM_RESULTS_PATH")
    os.environ["GASFM_RESULTS_PATH"] = str(out_dir / name)
    t0 = time.perf_counter()
    try:
        with stdout_to(out_dir / f"{name}.log"):
            rc = cli_main(["single-scene-optim", "--conf", "synth/optim_synth_gasfm.conf",
                           "--exp-dir", "mesh", "--external-params", "train.n_epochs=3",
                           "eval.eval_interval=3", "parallel.mesh_shape=[1,2]"]
                          + ([] if ts is None else ["parallel.table_sharding=false"]))
    finally:
        if before is None:
            os.environ.pop("GASFM_RESULTS_PATH", None)
        else:
            os.environ["GASFM_RESULTS_PATH"] = before
    wall = time.perf_counter() - t0
    root = out_dir / name
    exp = root / "mesh"
    csv = exp / "final_train_errors_OPTIMIZATION.csv"
    if rc != 0 or os.listdir(root) != ["mesh"] or not csv.exists():
        raise SmokeFailure(f"phase 18 CLI ({kind}): rc {rc}, tree {sorted(os.listdir(root))}")
    header, row = [line.split(",") for line in csv.read_text().splitlines()[:2]]
    repro = float(row[header.index("our_repro")])
    scenes = os.listdir(exp / "OPTIMIZATION")
    if len(scenes) != 1 or not math.isfinite(repro) or len(os.listdir(exp / "tb")) != 1:
        raise SmokeFailure(f"phase 18 CLI ({kind}): scenes {scenes}, our_repro {repro}")
    shutil.rmtree(exp / "code", ignore_errors=True)
    print(f"phase 18 CLI under [1, 2], {kind} (synth/optim_synth_gasfm.conf, 3 epochs): exit 0 "
          f"in {wall:.1f} s, one tree, final our_repro {repro:.4f}")
    record.setdefault("mesh_cli", {})[kind] = dict(seconds=wall, our_repro=repro)


MSL_MESH_TABLES = ("final_train_errors", "final_val_errors", "final_test_errors",
                   "best_val_errors", "final_train_errors_FINE_TUNE_from_final",
                   "final_train_errors_SHORT_OPTIMIZATION")


def mesh_msl_run(shape, record):
    """``multi-scene-learning`` on the synthetic GASFM conf under ``shape``
    ("[2,1]": groups of two sampled scenes per step and grouped evaluations;
    "[1,2]": table-sharded) for 3 epochs in batches of two, fine-tuning 1:
    exit 0, one tree, finite errors in every table. Into
    chiprun_out/phase18/."""
    import os
    import shutil

    from gasfm_tpu_torch.main import main as cli_main

    name = "msl" + shape.strip("[]").replace(",", "x")
    out_dir = ROOT / "chiprun_out" / "phase18"
    root = out_dir / name
    before = os.environ.get("GASFM_RESULTS_PATH")
    os.environ["GASFM_RESULTS_PATH"] = str(root)
    t0 = time.perf_counter()
    try:
        with stdout_to(out_dir / f"{name}.log"):
            rc = cli_main(["multi-scene-learning", "--conf", "synth/learning_synth_gasfm.conf",
                           "--exp-dir", "mesh", "--external-params", "train.n_epochs=3",
                           "eval.eval_interval=3", "train.finetune_n_epochs=1",
                           "dataset.batch_size=2", f"parallel.mesh_shape={shape}"])
    finally:
        if before is None:
            os.environ.pop("GASFM_RESULTS_PATH", None)
        else:
            os.environ["GASFM_RESULTS_PATH"] = before
    wall = time.perf_counter() - t0
    exp = root / "mesh"
    if rc != 0 or sorted(os.listdir(root)) != ["mesh"]:
        raise SmokeFailure(f"phase 18 learning CLI under {shape}: rc {rc}")
    errors = {}
    for table in MSL_MESH_TABLES:
        path = exp / f"{table}.csv"
        if not path.exists():
            raise SmokeFailure(f"phase 18 learning CLI under {shape}: no {table}.csv")
        rows = [line.split(",") for line in path.read_text().splitlines()]
        cols = [rows[0].index(c) for c in ("our_repro", "t_err_mean", "R_err_mean")]
        vals = [float(row[c]) for row in rows[1:] for c in cols]
        if not vals or not all(math.isfinite(v) for v in vals):
            raise SmokeFailure(f"phase 18 learning CLI under {shape}: {table} {vals}")
        errors[table] = vals[0]
    shutil.rmtree(exp / "code", ignore_errors=True)
    print(f"phase 18 learning CLI under {shape} (synth/learning_synth_gasfm.conf, 3 epochs in "
          f"batches of two, fine-tuning 1): exit 0 in {wall:.1f} s, one tree, finite errors; "
          f"our_repro of the first row {({k: round(v, 3) for k, v in errors.items()})}")
    record.setdefault("mesh_msl", {})[shape] = dict(seconds=wall, our_repro=errors)


# ---------------------------------------------------------------------------
# phase 19: multi-host parallel.distributed, two launchers that share the card
# ---------------------------------------------------------------------------


MULTIHOST_STEPS = 2  # the flagship's steps after the first
MULTIHOST_LABELS = {"a": FLAGSHIP_SHARDED, "b": "gasfm [2, 2]"}
MULTIHOST_TIMEOUT_S = 600
LAUNCHER = ("import sys; sys.path.insert(0, sys.argv[2]); import chip_smoke; "
            "sys.exit(chip_smoke.launcher_main(sys.argv[1]))")


def multihost_runs(labels):
    """Phase 18's runs of ``labels``, the flagship's with
    ``MULTIHOST_STEPS`` steps after its first."""
    runs = {r.label: r for r in mesh_runs()}
    return [runs[k]._replace(steps=1 + MULTIHOST_STEPS) if k == FLAGSHIP_SHARDED else runs[k]
            for k in labels]


def multihost_rank(mesh, labels, reservation):
    """One rank of phase 19 (``parallel.run_ranks``' function on each
    launcher): ``mesh_rank`` of the runs of ``labels``, the launcher's
    process id, and with ``reservation`` :func:`reservation_check`."""
    import os

    runs = multihost_runs(labels)
    out = mesh_rank(mesh, runs)
    out["launcher"] = os.getppid()
    if reservation:
        out["reservation"] = reservation_check(mesh, runs[0])
    return out


def reservation_check(mesh, run):
    """The flagship's grouped evaluation forward on the dense scene (the
    rank's table-sharded shard; ``run``'s model): its peak, the most that
    ``torch.cuda.max_memory_allocated`` rose above what was allocated
    before it (a second call: the first builds the graph's tables and the
    libraries' workspaces), beside ``TrainingSession.forward_bytes``, the
    bound that the evaluation reserves. Then ``epoch_evaluation`` of the
    scene (no BA, ``crash_on_scene_exhausting_memory=False``) with the last
    rank's reservation failing as if the card were full: rank 0's rows
    (None elsewhere), and the reservations that really ran."""
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.train.loop import epoch_evaluation
    from gasfm_tpu_torch.utils.phases import Phases

    dev = mesh.device
    session = mesh_session(run, dev, mesh)
    data = mesh_scene_data("dense", False)
    graph = session.scene_graph(data)
    session.forward_group([graph])
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    session.forward_group([graph])
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    bound = session.forward_bytes(graph)
    reserve, reserved = session.reserve_forward, []

    def reserve_forward(scene):
        if mesh.rank == mesh.size - 1:
            raise torch.cuda.OutOfMemoryError("the forward would not fit on this rank (faked)")
        reserve(scene)
        reserved.append(session.forward_bytes(scene))

    session.reserve_forward = reserve_forward
    conf = load_config("synth/learning_synth_gasfm.conf")
    table = epoch_evaluation([[data]], session, None, conf, 0, Phases.VALIDATION,
                             bundle_adjustment=False, crash_on_scene_exhausting_memory=False)
    g = graph.graph
    out = dict(peak=peak, bound=bound, reserved=reserved, edges=g.num_edges, points=g.num_pts,
               cams=g.num_cams, rows=None if table is None else table.rows)
    session.close()
    del session, graph
    gc.collect()
    torch.cuda.empty_cache()
    return out


def launcher_main(call_path):
    """One launcher process of phase 19: ``run_ranks`` on the card of the
    call in ``call_path`` (the name of this module's rank function, the
    mesh, its arguments, the host's ``Distributed``); its ranks' results,
    or its error's text, into ``call_path`` + ".out"."""
    from gasfm_tpu_torch.parallel import run_ranks

    name, shape, args, spec = torch.load(call_path, weights_only=False)
    try:
        out = ("ok", run_ranks(globals()[name], *shape, args=args, device="cuda",
                               distributed=spec))
    except Exception as e:  # noqa: BLE001 - the phase reports the error's text
        out = ("error", str(e))
    torch.save(out, call_path + ".out")
    return 0 if out[0] == "ok" else 1


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra):
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    env.update(extra)
    return env


def start_processes(commands, out_dir, name):
    """``commands`` (argument lists, each with its environment's extra
    variables) started from the repo's root at once, each logging to
    ``out_dir/<name><i>.log``."""
    procs = []
    for i, (cmd, extra) in enumerate(commands):
        log = open(out_dir / f"{name}{i}.log", "w")
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=child_env(**extra), stdout=log,
                                      stderr=subprocess.STDOUT))
        log.close()
    return procs


def wait_processes(procs, label):
    """The processes' exit codes, all of them stopped if one outlives
    ``MULTIHOST_TIMEOUT_S``."""
    deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
    try:
        return [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"phase 19 {label}: a process ran past {MULTIHOST_TIMEOUT_S} s") \
            from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def start_launchers(key, shape, reservation, out_dir):
    """The two launcher processes of run ``key`` on ``shape`` (process ids
    0 and 1, meeting at 127.0.0.1 and a free port): (processes, call
    paths)."""
    from gasfm_tpu_torch.parallel import Distributed

    port = free_port()
    paths, commands = [], []
    for pid in range(2):
        path = out_dir / f"{key}{pid}.pt"
        torch.save(("multihost_rank", shape, ([MULTIHOST_LABELS[key]], reservation),
                    Distributed("127.0.0.1", port, 2, pid)), path)
        paths.append(path)
        commands.append(([sys.executable, "-c", LAUNCHER, str(path), str(ROOT)], {}))
    return start_processes(commands, out_dir, f"launcher_{key}"), paths


def launcher_results(key, procs, paths):
    """Both launchers' ranks' results, in global rank order, after checking
    that each exited 0 with its own ranks (launcher ``pid`` runs global
    ranks ``pid x local`` onwards)."""
    import os

    rcs = wait_processes(procs, key)
    ranks = []
    for pid, (rc, path) in enumerate(zip(rcs, paths)):
        out = Path(f"{path}.out")
        status, res = (torch.load(out, weights_only=False) if out.exists()
                       else ("error", "no result"))
        os.remove(path)
        if out.exists():
            os.remove(out)
        if rc != 0 or status != "ok":
            raise SmokeFailure(f"phase 19 ({key}): launcher {pid} exit {rc}: {str(res)[-4000:]}")
        ranks += res
    local = len(ranks) // 2
    layout = [(r["rank"], r["launcher"]) for r in ranks]
    if [r for r, _ in layout] != list(range(len(ranks))) or \
            len({lau for _, lau in layout[:local]}) != 1 or \
            len({lau for _, lau in layout}) != 2:
        raise SmokeFailure(f"phase 19 ({key}): ranks and launchers {layout}")
    for r in ranks:
        if r["backend"] != "gloo" or not r["device"].startswith("cuda"):
            raise SmokeFailure(f"phase 19 ({key}): rank {r['rank']} on {r['backend']} "
                               f"{r['device']}")
    return ranks


def multihost_msl_start(out_dir):
    """``multi-scene-learning`` on the synthetic GASFM conf under [2, 1] as
    two CLI processes, process ids 0 and 1, with phase 18's settings;
    process 0 into ``out_dir/msl2x1``, process 1 into a directory of its
    own, which it must leave unmade."""
    port = free_port()
    commands = []
    for pid, results in enumerate(("msl2x1", "msl2x1_process1")):
        commands.append((
            [sys.executable, "-m", "gasfm_tpu_torch.main", "multi-scene-learning", "--conf",
             "synth/learning_synth_gasfm.conf", "--exp-dir", "mesh", "--external-params",
             "train.n_epochs=3", "eval.eval_interval=3", "train.finetune_n_epochs=1",
             "dataset.batch_size=2", "parallel.mesh_shape=[2,1]",
             "parallel.distributed.enabled=true",
             f'parallel.distributed.coordinator_address="127.0.0.1:{port}"',
             "parallel.distributed.num_processes=2", f"parallel.distributed.process_id={pid}"],
            {"GASFM_RESULTS_PATH": str(out_dir / results)}))
    return start_processes(commands, out_dir, "msl2x1_process")


def csv_rows(path):
    """A results CSV's rows by scene: the first column's name to the
    errors that phase 18 compares."""
    lines = [line.split(",") for line in path.read_text().splitlines()]
    cols = [lines[0].index(c) for c in ("our_repro", "t_err_mean", "R_err_mean")]
    return {row[0]: [float(row[c]) for c in cols] for row in lines[1:]}


def multihost_msl_check(procs, out_dir, record):
    """Both CLI processes exit 0; one tree, process 0's; every table's
    rows those of phase 18's [2, 1] run, finite, within the grouped
    evaluation's bounds (rtol 5e-3, atol 1e-3)."""
    import os
    import shutil

    rcs = wait_processes(procs, "(c)")
    root = out_dir / "msl2x1"
    if rcs != [0, 0] or sorted(os.listdir(root)) != ["mesh"] or \
            (out_dir / "msl2x1_process1").exists():
        raise SmokeFailure(f"phase 19 (c): exit codes {rcs}, trees "
                           f"{sorted(p.name for p in out_dir.iterdir() if p.is_dir())}")
    worst = 0.0
    for table in MSL_MESH_TABLES:
        got = csv_rows(root / "mesh" / f"{table}.csv")
        want = csv_rows(ROOT / "chiprun_out" / "phase18" / "msl2x1" / "mesh" / f"{table}.csv")
        if list(got) != list(want):
            raise SmokeFailure(f"phase 19 (c): {table} rows {list(got)} against phase 18's "
                               f"{list(want)}")
        for scene, vals in got.items():
            for a, b in zip(vals, want[scene]):
                if not math.isfinite(a) or abs(a - b) > 1e-3 + 5e-3 * abs(b):
                    raise SmokeFailure(f"phase 19 (c): {table} {scene} {vals} against phase "
                                       f"18's {want[scene]}")
                worst = max(worst, abs(a - b) / max(abs(b), 1e-12))
    shutil.rmtree(root / "mesh" / "code", ignore_errors=True)
    record["c"] = dict(tables=len(MSL_MESH_TABLES), worst_rel=worst)
    print(f"phase 19 (c) multi-scene learning under [2, 1] as two CLI processes "
          f"(synth/learning_synth_gasfm.conf, phase 18's settings): both exit 0, one tree, "
          f"process 0's; {len(MSL_MESH_TABLES)} tables with phase 18's rows, finite, largest "
          f"relative difference {worst:.2e} ok")


def multihost_phase(dev, record, mesh_results):
    """Phase 19: multi-host ``parallel.distributed``, two launcher
    processes on this machine meeting on a TCP store at 127.0.0.1 and a
    free port, their ranks sharing the card over gloo: (a) the flagship
    table-sharded under [1, 2], one rank per launcher, against phase 18's
    one-launcher run (step-1 loss and gradients, then 2 steps, the weights
    bitwise equal on both ranks after each, launches per step, ms per step
    and the gradient all-reduce), and (d) its grouped evaluation forward's
    reserved bound against the measured peak, a reservation failure faked
    on rank 1; then at once (b) GASFM at 2 layers under [2, 2], two local
    ranks per launcher, against phase 18's, and (c) ``multi-scene-learning``
    under [2, 1] as two CLI processes against phase 18's."""
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out" / "phase19"
    if out_dir.exists():
        import shutil

        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    summary = {}
    t0 = time.perf_counter()
    ranks_a = launcher_results("a", *start_launchers("a", (1, 2), True, out_dir))
    print(f"phase 19 (a): two launchers of one rank each, spawned, run and joined in "
          f"{time.perf_counter() - t0:.1f} s; " + "; ".join(
              f"rank {r['rank']} (launcher pid {r['launcher']}) {r['backend']} on {r['device']}"
              for r in ranks_a))
    t0 = time.perf_counter()
    procs_b = start_launchers("b", (2, 2), False, out_dir)
    procs_c = multihost_msl_start(out_dir)

    # (a) against phase 18's one-launcher run of the same mesh
    run = multihost_runs([FLAGSHIP_SHARDED])[0]
    names = [k for k, p in GraphAttnSfMNet(**run.model[1]).named_parameters() if p.requires_grad]
    got = [r["runs"][FLAGSHIP_SHARDED] for r in ranks_a]
    want = mesh_results[FLAGSHIP_SHARDED]
    g0, w0 = got[0], want[0]
    for r in got[1:]:
        if r["digests"] != g0["digests"]:
            raise SmokeFailure("phase 19 (a): weights differ between the launchers' ranks")
    loss, ref_loss = g0["values"][0][0], w0["values"][0][0]
    errs = mesh_grad_errors(g0["grads"], w0["grads"], flagship_grad_rule(record, names))
    bad = [e for e in errs if e[1] > e[3] or not e[4]]
    bitwise = sum(torch.equal(a, b) for a, b in zip(g0["grads"], w0["grads"]))
    worst = max(errs, key=lambda e: e[1] / max(e[3], 1e-30))
    launches = [r["launches"] == w["launches"][:len(r["launches"])] for r, w in zip(got, want)]
    print(f"phase 19 (a) {FLAGSHIP_SHARDED} on two launchers: step-1 loss {loss!r} against the "
          f"one launcher's {ref_loss!r} ({'bitwise' if loss == ref_loss else 'differs'}); "
          f"{len(errs)} gradients against the one launcher's, {bitwise} bitwise equal, the "
          f"closest to its bound (phase 5's rule taken twice) {names[worst[0]]}: max |err| "
          f"{worst[1]:.3e}, allowed {worst[3]:.3e} {'ok' if not bad else 'FAIL'}")
    if bad or abs(loss - ref_loss) > 1e-5 * abs(ref_loss) or not all(launches):
        raise SmokeFailure(f"phase 19 (a): loss {loss} / {ref_loss}, gradients "
                           f"{[(names[e[0]], e[1], e[3]) for e in bad[:8]]}, launches as the "
                           f"one launcher's {launches}")
    ms, ref_ms = [round(t, 1) for t in g0["ms"]], [round(t, 1) for t in w0["ms"]]
    print(f"phase 19 (a): weights equal on both ranks after each of {len(g0['ms'])} steps; "
          f"launches per rank per step those of the one launcher's {g0['launches'][-1]}; ms "
          f"per step {ms} against the one launcher's {ref_ms}; the gradient all-reduce alone "
          f"{g0['allreduce_ms']:.1f} ms against {w0['allreduce_ms']:.1f} ms for "
          f"{g0['grad_bytes'] / 2**20:.1f} MiB; later losses "
          f"{[v[0] for v in g0['values'][1:]]}")
    summary["a"] = dict(loss=loss, one_launcher_loss=ref_loss, grads_bitwise=bitwise,
                        grads=len(errs), grad_worst=(names[worst[0]], worst[1], worst[3]),
                        ms=g0["ms"], one_launcher_ms=w0["ms"], allreduce_ms=g0["allreduce_ms"],
                        one_launcher_allreduce_ms=w0["allreduce_ms"],
                        launches_per_step=g0["launches"][-1])

    # (d) the reservation before a mesh's grouped evaluation forward
    res = [r["reservation"] for r in ranks_a]
    rows = res[0]["rows"]
    numbers = [] if rows is None else [v for v in rows[0][1].values() if isinstance(v, float)]
    nan_row = len(rows or ()) == 2 and bool(numbers) and all(math.isnan(v) for v in numbers)
    within = [r["peak"] <= r["bound"] <= 2 * r["peak"] for r in res]
    for k, r in enumerate(res):
        print(f"phase 19 (d) rank {k}: the flagship's grouped evaluation forward on the dense "
              f"scene's shard ({r['edges']} edges, {r['points']} points, {r['cams']} cameras): "
              f"peak {r['peak'] / 2**20:.1f} MiB above what was allocated, the reserved bound "
              f"{r['bound'] / 2**20:.1f} MiB ({r['bound'] / r['peak']:.2f} x) "
              f"{'ok' if within[k] else 'FAIL'}")
    print(f"phase 19 (d): rank 1's reservation failing (faked), rank 0's reserved "
          f"{[round(b / 2**20, 1) for b in res[0]['reserved']]} MiB and passed: rank 0's rows "
          f"{[name for name, _ in rows] if rows else rows}, the scene's row "
          f"{'all NaN' if nan_row else 'NOT all NaN'}; rank 1 "
          f"{'None' if res[1]['rows'] is None else 'a table'}")
    if not all(within) or not nan_row or res[1]["rows"] is not None or \
            res[0]["reserved"] != [res[0]["bound"]]:
        raise SmokeFailure(f"phase 19 (d): bounds within [peak, 2 x peak] {within}, the agreed "
                           f"dummy row {nan_row}")
    summary["d"] = [dict(peak=r["peak"], bound=r["bound"], edges=r["edges"], points=r["points"],
                         cams=r["cams"]) for r in res]

    # (b) [2, 2], two local ranks per launcher, against phase 18's
    ranks_b = launcher_results("b", *procs_b)
    label = MULTIHOST_LABELS["b"]
    got = [r["runs"][label] for r in ranks_b]
    want = mesh_results[label]
    g0, w0 = got[0], want[0]
    for r in got[1:]:
        if r["digests"] != g0["digests"]:
            raise SmokeFailure("phase 19 (b): weights differ between the launchers' ranks")
    first, ref_first = g0["values"][0], w0["values"][0]
    G = max(float(m.abs().max()) for m in w0["mu"])
    errs = mesh_grad_errors(g0["mu"], w0["mu"], lambda k, scale: 1e-4 * scale + MESH_GRAD_EPS * G)
    bad = [e for e in errs if e[1] > e[3] or not e[4]]
    bitwise = sum(torch.equal(a, b) for a, b in zip(g0["mu"], w0["mu"]))
    close = first[2] == ref_first[2] and all(
        abs(a - b) <= 1e-4 * abs(b) for a, b in zip(first, ref_first))
    launches = all(r["launches"] == w["launches"] for r, w in zip(got, want))
    print(f"phase 19 (b) {label} on two launchers of two local ranks (global ranks "
          f"{[r['rank'] for r in ranks_b[:2]]} on process 0, {[r['rank'] for r in ranks_b[2:]]} on "
          f"process 1), spawned, run and joined in {time.perf_counter() - t0:.1f} s: (loss, "
          f"our_repro, n_valid, grad_norm) {first} against the one launcher's {ref_first} "
          f"({'bitwise' if first == ref_first else 'differs'}); {len(errs)} first moments, "
          f"{bitwise} bitwise equal; weights equal on all 4 ranks; launches as the one "
          f"launcher's {'ok' if close and not bad and launches else 'FAIL'}")
    if not close or bad or not launches:
        raise SmokeFailure(f"phase 19 (b): {first} / {ref_first}, first moments "
                           f"{[(e[0], e[1], e[3]) for e in bad[:8]]}, launches {launches}")
    summary["b"] = dict(first=first, one_launcher_first=ref_first, mu_bitwise=bitwise,
                        mu=len(errs), ms=g0["ms"], one_launcher_ms=w0["ms"])

    # (c) the CLI on two processes
    multihost_msl_check(procs_c, out_dir, summary)
    record["multihost"] = summary
    record["multihost_phase_s"] = time.perf_counter() - t_phase
    print(f"phase 19 (multi-host parallel.distributed, two launchers): "
          f"{record['multihost_phase_s']:.1f} s")



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

    counters = kernel_counters()
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

    # ---- phase 17: mixed precision (bf16 moments, bf16 weights with an f32
    # master) through the port's Adam kernel
    mixed_launches, adam = mixed_precision_phase(dev, scenes, counters, record, L)
    if mixed_launches["adam_update"] == 0:
        raise SmokeFailure("adam_update was never launched on the mixed-precision path")

    # ---- phase 18: multi-device training, scene data parallelism, edge
    # partitioning and table sharding, with ranks that share the card
    mesh_results = mesh_phase(dev, counters, record, L, {**scenes, "wide": wide["wide"]})

    # ---- phase 19: multi-host parallel.distributed, two launchers on this
    # machine meeting on a TCP store, their ranks sharing the card
    multihost_phase(dev, record, mesh_results)

    # ---- phase 20: the activation-memory options: the six edge-tile
    # kernels' bf16 forms against their plain versions, then bf16 edge
    # streams (and the fast configuration), the depth flagship under them,
    # layer remat and the CLI with both keys
    with torch.no_grad():
        per_scene["bf16_forms"] = memory_kernel_phase(
            dev, {"dense": scenes["dense"].graph, "powerlaw": scenes["powerlaw"].graph,
                  "hub_camera": hub_camera_graph(scenes["dense"].graph)}, record)
    bf16_paths = memory_options_phase(dev, scenes, counters, record, L)
    for name, (_, path) in BF16_FORMS.items():
        if not bf16_paths[path].get(name):
            raise SmokeFailure(f"{name} was never launched on the {path} training path")

    # ---- phase 13: the record
    kernels = []
    for name, (source, replaces, path) in KERNELS.items():
        r = per_scene["wide" if path == "wide" else "dense"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[path][name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            burst_ms=r["burst_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms")))
    for name, (wrapper, path) in BF16_FORMS.items():
        r = per_scene["bf16_forms"][wrapper]
        source, replaces, _ = KERNELS[wrapper]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=bf16_paths[path][name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            device_ms=r["device_ms"], library_ms=None))
    a = adam["a"]  # the JAX bench's configuration, on the (a) path
    kernels.append(dict(
        name="adam_update", route="cuda", source=ADAM_SOURCE, replaces=ADAM_REPLACES,
        launches=mixed_launches["adam_update"], max_abs_err=a["max_abs_err"], ms=a["ms"],
        burst_ms=a["burst_ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
        bound_by=a["bound_by"], library_ms=a["library_ms"]))
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
