"""The port's CLI: ``single-scene-optim`` and ``multi-scene-learning`` on the
card (or the CPU).

Counterpart of the JAX package's main.py (reference code/main.py): the same
subcommands, aliases and flags (``parse_args``), the conf load with
``--external-params`` merged and checked (``init_exp``), the seeded model
with optional pretrained weights (``init_model``; with ``--old-exp-dir``,
``<dir>/models/<--pretrained-model-filename or best_model.npz>``), the
experiment directory and ``main``'s phases: single-scene optimization, or
multi-scene learning (training, the final and best weights' evaluations,
fine-tuning of every test scene from each, short optimization from fresh
weights; ``--skip-training``, ``--skip-fine-tuning[-from-best|-from-final]``,
``--skip-short-optim``). One flag is the port's own: ``--device`` (default
``cuda``; without a GPU ``main`` raises unless given ``--device cpu``).
``--accelerator-not-required`` is accepted and ignored, as in the JAX CLI.
The common flags may come before or after the subcommand::

    python -m gasfm_tpu_torch.main single-scene-optim --conf gasfm/optim_euc_gasfm.conf
    python -m gasfm_tpu_torch.main --conf synth/optim_synth_gasfm.conf single-scene-optim \
        --device cpu --external-params train.n_epochs=20 eval.eval_interval=10
    python -m gasfm_tpu_torch.main multi-scene-learning --conf synth/learning_synth_gasfm.conf

It writes the JAX CLI's tree under ``$GASFM_RESULTS_PATH`` (default
``results/``) / ``exp_dir``: ``code/`` (the package's source and
``exp.conf.json``), ``tb/events.out.tfevents.*``,
``OPTIMIZATION/<scene>/models/final_model.npz`` (the JAX package's npz
layout), ``.../predictions/final_predictions.npz``,
``.../plots/final_plots.html`` (calibrated scenes) and
``final_train_errors_OPTIMIZATION.csv`` / ``.xlsx``; for multi-scene learning
``TRAINING/models/{final_model,best_model,model_epoch*}.npz``,
``train_stats``, ``{final,best}_{train,val,test}_errors``, the evaluations'
predictions and plots per set and scene, and per test scene the
fine-tuning's (``FINE_TUNE_from_final``, ``FINE_TUNE_from_best``) and the
short optimization's trees and ``final_train_errors_<PHASE>[_id]`` tables.

Conf keys the port reads and does not act on: the rest of ``compile.*``
(the edge chunk, the bucket multiples and growth, ``kernel_precision``,
``donate_state``, ``dtype``), the JAX package's TPU layout devices. Its two
activation-memory options act: ``compile.stream_dtype = "bf16"`` stores the
merged path's edge streams and their cotangents in bfloat16, and
``model.remat_layers`` rematerializes each GASFM layer in the backward
(``GraphAttnSfMNet(stream_dtype=..., remat_layers=...)``, read by
``conf_kwargs``). bf16 Adam moments and bf16 weights with an
f32 master (``train.adam_mu_dtype``, ``train.adam_nu_dtype``,
``train.param_dtype``) train through the port's Adam kernel
(``train.state.optim_from_conf``; the weight files then hold bf16 leaves,
as the JAX package's do).

A conf with a ``parallel.mesh_shape = [n_data, n_edge]`` of more than one
position runs either subcommand on a mesh: ``main`` launches ``n_data *
n_edge`` ranks itself (``parallel.run_ranks``: spawned processes on a gloo
process group, sharing the cards round robin, or on the CPU with ``--device
cpu``), every rank runs the same drivers with the same conf and seeds on
its edge shard (with ``parallel.table_sharding`` null or true, and more
than one edge shard, over a point table sharded between the ranks), and
only rank 0 prints, writes the tree and runs BA. Multi-scene learning
trains on groups of sampled scenes (one per data slot), evaluates in
groups, and every rank fine-tunes and short-optimizes each test scene on
the mesh. With ``parallel.distributed`` enabled the mesh spans hosts: the
user starts one CLI per host, each with the same conf but its own
``parallel.distributed.process_id`` (and the same ``coordinator_address``,
process 0's host and a free port, and ``num_processes``), as the JAX
package's CLI is run; each launches its ``n_data * n_edge /
num_processes`` local ranks (``parallel.run_ranks``), the ranks of every
host meet on a TCP store at the coordinator, and only process 0 wipes the
experiment (``--overwrite-exp``) and snapshots the code, as only global rank
0 prints and writes::

    python -m gasfm_tpu_torch.main multi-scene-learning --conf synth/learning_synth_gasfm.conf \
        --external-params 'parallel.mesh_shape=[2,1]' parallel.distributed.enabled=true \
        'parallel.distributed.coordinator_address="host0:29500"' \
        parallel.distributed.num_processes=2 parallel.distributed.process_id=0
"""

from __future__ import annotations

import argparse
import gc
import os
import random
import shutil
from datetime import datetime
from typing import Optional, Tuple

import numpy as np
import torch


def _common_flags(p: argparse.ArgumentParser, top: bool) -> None:
    """The flags every subcommand takes, on the top-level parser (``top``,
    with their defaults) and on each subcommand's (default
    ``argparse.SUPPRESS``, so that a flag given before the subcommand is
    not reset after it)."""
    def default(value):
        return value if top else argparse.SUPPRESS

    p.add_argument("--conf", type=str, default=default(None))
    p.add_argument("--exp-dir", "--exp_dir", type=str, default=default(None))
    p.add_argument("--overwrite-exp", "--overwrite_exp", action="store_true",
                   default=default(False))
    p.add_argument("--external-params", "--external_params", type=str, nargs="*",
                   default=default([]))
    p.add_argument("--pretrained-model-path", "--pretrained_model_path", type=str,
                   default=default(None))
    # the reference's --gpu-not-required (main.py:50): accepted and ignored
    p.add_argument("--accelerator-not-required", "--gpu-not-required", "--gpu_not_required",
                   action="store_true", default=default(False))
    p.add_argument("--count-model-params-and-die", "--count_model_params_and_die",
                   action="store_true", default=default(False))
    p.add_argument("--device", type=str, default=default("cuda"),
                   help="the device to run on: cuda (default) or cpu")


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX CLI's arguments (its main.py:26-71) and ``--device``."""
    parser = argparse.ArgumentParser(prog="python -m gasfm_tpu_torch.main")
    _common_flags(parser, top=True)
    subparsers = parser.add_subparsers(help="Mode-specific arguments.", dest="mode")
    subparsers.required = True

    sso = subparsers.add_parser("single-scene-optim", aliases=["single_scene_optim"])
    sso.set_defaults(mode="single_scene_optim")
    sso.add_argument("--scene", type=str, default=None)
    sso.add_argument("--scene-name-exp-subdir", "--scene_name_exp_subdir", action="store_true",
                     default=False)

    msl = subparsers.add_parser("multi-scene-learning", aliases=["multi_scene_learning"])
    msl.set_defaults(mode="multi_scene_learning", scene=None, scene_name_exp_subdir=None)
    msl.add_argument("--old-exp-dir", "--old_exp_dir", type=str, default=None)
    msl.add_argument("--pretrained-model-filename", "--pretrained_model_filename", type=str,
                     default=None)
    for flag in ("skip-training", "skip-fine-tuning", "skip-fine-tuning-from-best",
                 "skip-fine-tuning-from-final", "skip-short-optim"):
        msl.add_argument(f"--{flag}", f"--{flag.replace('-', '_')}", action="store_true",
                         default=False)

    for p in (sso, msl):
        _common_flags(p, top=False)
    args = parser.parse_args(argv)
    if args.conf is None:
        parser.error("the following arguments are required: --conf")
    return args


def init_exp(args):
    """The conf of ``args.conf`` (a path, or a name under the port's
    ``confs/``) with ``args.external_params`` merged and checked against
    ``ref.conf``; ``dataset.scene`` set from ``args.scene`` when given and
    ``exp_dir`` from ``args.exp_dir``, the conf's own, or a timestamp (under
    the scene's name with ``args.scene_name_exp_subdir``). Seeds ``random``
    and numpy with ``random_seed`` and returns (conf, a numpy Generator of
    the same seed)."""
    from gasfm_tpu_torch.config import load_config

    conf = load_config(args.conf, external_params=args.external_params)
    if args.scene is not None:
        conf.put("dataset.scene", args.scene)
    exp_dir = (args.exp_dir or conf.get_string("exp_dir", default=None)
               or "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now()))
    if args.scene_name_exp_subdir:
        exp_dir = os.path.join(exp_dir, conf.get_string("dataset.scene"))
    conf.put("exp_dir", exp_dir)
    return conf, seed_from_conf(conf)


def seed_from_conf(conf) -> np.random.Generator:
    """Seed ``random`` and numpy with ``random_seed``; a numpy Generator of
    the same seed."""
    seed = conf.get_int("random_seed", default=0)
    random.seed(seed)
    np.random.seed(seed)
    return np.random.default_rng(seed)


def init_model(conf, pretrained_model_path: Optional[str] = None
               ) -> Tuple[torch.nn.Module, int]:
    """The model of ``model.type``, its weights drawn from a generator
    seeded with ``random_seed`` (the port's initializer: the JAX package's
    PRNG bits do not carry over), on the CPU until a session moves it;
    prints ``#Trainable parameters: N``. With ``pretrained_model_path``,
    loads a weight file of either package (``train.state.load_params``:
    keys the file lacks keep their init, keys the model lacks are ignored).
    Returns (model, N)."""
    from gasfm_tpu_torch.models import get_model
    from gasfm_tpu_torch.train.state import load_params

    gen = torch.Generator().manual_seed(conf.get_int("random_seed", default=0))
    model = get_model(conf, generator=gen)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"#Trainable parameters: {n_params}")
    if pretrained_model_path is not None:
        load_params(pretrained_model_path, model)
    return model, n_params


def _mesh_rank(mesh, conf, args, pretrained: Optional[str]) -> int:
    """One rank of a mesh run: the seeded model (rank 0's weights reach
    every rank when its session is made), the subcommand's drivers on this
    rank's shard; only rank 0 prints and writes."""
    import sys

    if not mesh.is_writer:
        sys.stdout = open(os.devnull, "w")
    rng = seed_from_conf(conf)
    model, _ = init_model(conf, pretrained)
    if args.mode == "single_scene_optim":
        from gasfm_tpu_torch.experiments import train_model_single_scene
        from gasfm_tpu_torch.utils.phases import Phases

        train_model_single_scene(conf, model, Phases.OPTIMIZATION, rng=rng, device=mesh.device,
                                 mesh=mesh)
    else:
        learn(conf, args, model, rng, mesh.device, mesh)
    return 0


def learn(conf, args, model, rng: np.random.Generator, device, mesh=None) -> None:
    """Multi-scene learning: TRAINING -> the final and best weights'
    evaluations -> FINE_TUNE of every test scene from each -> SHORT_OPTIMIZATION
    from fresh weights, as ``args``' skip flags allow; on ``mesh`` (this
    rank's) every phase runs on the mesh."""
    from gasfm_tpu_torch.experiments import (create_eval_dataloaders, eval_model,
                                             optimization_all_test_scenes, train_model)
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.utils.phases import Phases

    datasets, eval_loaders = create_eval_dataloaders(conf, rng=rng)
    session = TrainingSession.from_conf(conf, model, device=device, mesh=mesh)
    if not args.skip_training:
        trained, _ = train_model(conf, session, datasets["train_set"], eval_loaders,
                                 Phases.TRAINING, rng=rng)
    else:
        weights = session.weights()
        trained = {"final_model": weights, "best_model": weights}
    eval_model(conf, session, trained["final_model"], eval_loaders, -1, "final_", rng=rng)
    if "best_model" in trained:
        eval_model(conf, session, trained["best_model"], eval_loaders, None, "best_", rng=rng)
    session.close()  # one session on the device at a time
    del session
    gc.collect()

    def fine_tune(weights, phase, identifier=None):
        optimization_all_test_scenes(conf, model, weights, phase,
                                     additional_identifier=identifier, rng=rng, device=device,
                                     mesh=mesh)

    if not args.skip_fine_tuning and not args.skip_fine_tuning_from_final:
        fine_tune(trained["final_model"], Phases.FINE_TUNE, "from_final")
    if ("best_model" in trained and not args.skip_fine_tuning
            and not args.skip_fine_tuning_from_best):
        fine_tune(trained["best_model"], Phases.FINE_TUNE, "from_best")
    if not args.skip_short_optim:
        fine_tune(init_model(conf)[0].state_dict(), Phases.SHORT_OPTIMIZATION)


def main(argv=None) -> int:
    """Run the CLI (see the module docstring). Returns 0."""
    from gasfm_tpu_torch.parallel import distributed_from_conf, mesh_shape_from_conf, run_ranks
    from gasfm_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    conf, rng = init_exp(args)
    mesh_shape = mesh_shape_from_conf(conf)
    distributed = distributed_from_conf(conf)
    # on a shared file system another host's wipe would delete process 0's tree
    writer = distributed is None or distributed.process_id == 0

    from gasfm_tpu_torch.experiments import train_model_single_scene
    from gasfm_tpu_torch.utils.observability import log_code
    from gasfm_tpu_torch.utils.paths import path_to_exp
    from gasfm_tpu_torch.utils.phases import Phases

    pretrained = args.pretrained_model_path
    if pretrained is None and getattr(args, "old_exp_dir", None):
        name = args.pretrained_model_filename or "best_model.npz"
        pretrained = os.path.join(args.old_exp_dir, "models", name)
    if mesh_shape is None or args.count_model_params_and_die:
        model, _ = init_model(conf, pretrained)
    if args.count_model_params_and_die:
        return 0
    if args.overwrite_exp and writer:
        exp_path = path_to_exp(conf, create=False)
        if os.path.exists(exp_path):
            shutil.rmtree(exp_path)
    if writer:
        log_code(conf)
    if mesh_shape is not None:  # the ranks take it from here, each with this conf
        run_ranks(_mesh_rank, *mesh_shape, args=(conf, args, pretrained), device=device.type,
                  distributed=distributed)
        return 0
    if args.mode == "single_scene_optim":
        train_model_single_scene(conf, model, Phases.OPTIMIZATION, rng=rng, device=device)
        return 0
    learn(conf, args, model, rng, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
