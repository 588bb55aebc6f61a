"""Experiment set-up from a conf: ``init_exp`` and ``init_model``.

Counterpart of ``init_exp`` and ``init_model`` in the JAX package's main.py
(:75-107, :110-131; reference main.py:74-190). The CLI itself
(``parse_args``, ``main``: the ``single-scene-optim`` and
``multi-scene-learning`` subcommands) and the experiment directory's
artifacts are not ported yet.

A session from a shipped conf, on the card::

    conf, rng = init_exp(argparse.Namespace(conf="gasfm/optim_euc_gasfm.conf",
                                            external_params=[], scene=None,
                                            exp_dir="exp", scene_name_exp_subdir=False))
    model, n_params = init_model(conf)
    session = TrainingSession.from_conf(conf, model)
    scene = create_scene_data(conf).to_scene_graph()

Conf keys the port reads and does not act on: ``compile.*`` (the edge chunk,
``stream_dtype``, the bucket multiples and growth, ``kernel_precision``,
``donate_state``, ``dtype``) and ``model.remat_layers``, the JAX package's
TPU layout and memory devices. Options the port has not ported yet raise
``NotImplementedError`` where they are read, rather than run something
other than the conf asks for: bf16 parameters or Adam moments
(``train.param_dtype``, ``train.adam_mu_dtype``, ``train.adam_nu_dtype``;
``train.state.optim_from_conf``) and a ``parallel.mesh_shape`` of more than
one device (``TrainingSession.from_conf``).
"""

from __future__ import annotations

import os
import random
from datetime import datetime
from typing import Optional, Tuple

import numpy as np
import torch


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
