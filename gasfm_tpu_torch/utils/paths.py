"""Experiment directory scheme.

A copy of the JAX package's utils/paths.py (reference
code/utils/path_utils.py:6-97):
``results/{exp_dir}/{PHASE_identifiers}/{scene}/{models,predictions,plots}``
with epoch-numbered filenames and best_/final_ prefixes. The results root is
configurable via GASFM_RESULTS_PATH (defaults to ./results).
"""

from __future__ import annotations

import os
from typing import List, Optional

from gasfm_tpu_torch.utils.phases import Phases


def join_and_create(*args, create: bool = True) -> str:
    full_path = os.path.join(*args)
    if create:
        os.makedirs(full_path, exist_ok=True)
    return full_path


def path_to_exp_root(conf) -> str:
    return os.environ.get("GASFM_RESULTS_PATH", "results")


def path_to_exp(conf, create: bool = True) -> str:
    exp_dir = conf.get_string("exp_dir")
    return join_and_create(path_to_exp_root(conf), exp_dir, create=create)


def path_to_phase(conf, phase: Phases, additional_identifiers: Optional[List[str]] = None) -> str:
    subdir = "_".join([phase.name] + list(additional_identifiers or []))
    return join_and_create(path_to_exp(conf), subdir)


def path_to_scene(conf, phase, scene=None, additional_identifiers=None) -> str:
    phase_path = path_to_phase(conf, phase, additional_identifiers)
    scene = conf.get_string("dataset.scene") if scene is None else scene
    return join_and_create(phase_path, scene)


def path_to_models_dir(conf, phase, scene=None, additional_identifiers=None) -> str:
    if phase in (Phases.TRAINING, Phases.VALIDATION, Phases.TEST):
        parent = path_to_exp(conf)
    else:
        parent = path_to_scene(conf, phase, scene=scene, additional_identifiers=additional_identifiers)
    return join_and_create(parent, "models")


def path_to_predictions(conf, phase, epoch=None, scene=None, additional_identifiers=None) -> str:
    scene_path = path_to_scene(conf, phase, scene=scene, additional_identifiers=additional_identifiers)
    pred_path = join_and_create(scene_path, "predictions")
    if epoch is None:
        name = "best_predictions"
    elif epoch == -1:
        name = "final_predictions"
    else:
        name = f"predictions_epoch{epoch + 1:06d}"
    return os.path.join(pred_path, name)


def path_to_plots(conf, phase, epoch=None, scene=None, additional_identifiers=None) -> str:
    scene_path = path_to_scene(conf, phase, scene=scene, additional_identifiers=additional_identifiers)
    plots_path = join_and_create(scene_path, "plots")
    if epoch is None:
        name = "best_plots.html"
    elif epoch == -1:
        name = "final_plots.html"
    else:
        name = f"plot_epoch{epoch + 1:06d}.html"
    return os.path.join(plots_path, name)


def path_to_tb_events(conf) -> str:
    return join_and_create(path_to_exp(conf), "tb")


def path_to_code_logs(conf) -> str:
    return join_and_create(path_to_exp(conf), "code")


def gen_dflt_exp_dir() -> str:
    from datetime import datetime

    return "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now())


def get_additional_identifiers_for_outlier_injection(outlier_injection_rate) -> List[str]:
    """Parity: reference general_utils.py:113-117."""
    if outlier_injection_rate is None:
        return []
    return [f"outlier_rate{outlier_injection_rate:.2f}"]
