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

Conf keys the port reads and does not act on: ``compile.*`` (the edge chunk,
``stream_dtype``, the bucket multiples and growth, ``kernel_precision``,
``donate_state``, ``dtype``) and ``model.remat_layers``, the JAX package's
TPU layout and memory devices. Options the port has not ported yet raise
``NotImplementedError`` where they are read, rather than run something
other than the conf asks for: bf16 parameters or Adam moments
(``train.param_dtype``, ``train.adam_mu_dtype``, ``train.adam_nu_dtype``;
``train.state.optim_from_conf``), a ``parallel.mesh_shape`` of more than
one device (``TrainingSession.from_conf``).
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

    seed = conf.get_int("random_seed", default=0)
    random.seed(seed)
    np.random.seed(seed)
    return conf, np.random.default_rng(seed)


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


def main(argv=None) -> int:
    """Run the CLI (see the module docstring). Returns 0."""
    from gasfm_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    conf, rng = init_exp(args)

    from gasfm_tpu_torch.experiments import (create_eval_dataloaders, eval_model,
                                             optimization_all_test_scenes, train_model,
                                             train_model_single_scene)
    from gasfm_tpu_torch.train.loop import TrainingSession
    from gasfm_tpu_torch.utils.observability import log_code
    from gasfm_tpu_torch.utils.paths import path_to_exp
    from gasfm_tpu_torch.utils.phases import Phases

    pretrained = args.pretrained_model_path
    if pretrained is None and getattr(args, "old_exp_dir", None):
        name = args.pretrained_model_filename or "best_model.npz"
        pretrained = os.path.join(args.old_exp_dir, "models", name)
    model, _ = init_model(conf, pretrained)
    if args.count_model_params_and_die:
        return 0
    if args.overwrite_exp:
        exp_path = path_to_exp(conf, create=False)
        if os.path.exists(exp_path):
            shutil.rmtree(exp_path)
    log_code(conf)
    if args.mode == "single_scene_optim":
        train_model_single_scene(conf, model, Phases.OPTIMIZATION, rng=rng, device=device)
        return 0

    # multi-scene learning: TRAINING -> final / best evaluations -> FINE_TUNE
    # from the final and the best weights -> SHORT_OPTIMIZATION from fresh ones
    datasets, eval_loaders = create_eval_dataloaders(conf, rng=rng)
    session = TrainingSession.from_conf(conf, model, device=device)
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

    if not args.skip_fine_tuning and not args.skip_fine_tuning_from_final:
        optimization_all_test_scenes(conf, model, trained["final_model"], Phases.FINE_TUNE,
                                     additional_identifier="from_final", rng=rng, device=device)
    if ("best_model" in trained and not args.skip_fine_tuning
            and not args.skip_fine_tuning_from_best):
        optimization_all_test_scenes(conf, model, trained["best_model"], Phases.FINE_TUNE,
                                     additional_identifier="from_best", rng=rng, device=device)
    if not args.skip_short_optim:
        fresh = init_model(conf)[0].state_dict()
        optimization_all_test_scenes(conf, model, fresh, Phases.SHORT_OPTIMIZATION, rng=rng,
                                     device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
