"""Multi-scene learning driver.

Counterpart of the JAX package's experiments/multi_scene.py (reference
code/multiple_scenes_learning.py:14-136): the train / validation / test
scene sets and their loaders, the training wrapper, the evaluation of a set
of weights on the three sets, and the fine-tuning of every test scene from
given weights, each in a single-scene session of its own.

Where the JAX package evaluates the trained weights in a new session, the
port loads them into the training session's model in place, so that the
evaluation scenes' recorded forwards replay; and fine-tuning loads the
given weights into the same model before each test scene, whose session is
closed before the next begins: one session holds the device at a time.
"""

from __future__ import annotations

import gc
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from gasfm_tpu_torch.data.dataset import SceneLoader, ScenesDataSet
from gasfm_tpu_torch.data.loaders import create_scene_data_from_list
from gasfm_tpu_torch.experiments.single_scene import train_model_single_scene
from gasfm_tpu_torch.train.loop import TrainingSession, epoch_evaluation, train
from gasfm_tpu_torch.utils.observability import write_results
from gasfm_tpu_torch.utils.paths import get_additional_identifiers_for_outlier_injection
from gasfm_tpu_torch.utils.phases import Phases


def create_eval_dataloaders(conf, rng: Optional[np.random.Generator] = None
                            ) -> Tuple[Dict, Dict]:
    """The four datasets (the sampled, augmented training set; the training,
    validation and test sets whole) and the three evaluation loaders
    (reference multiple_scenes_learning.py:14-53)."""
    min_views = conf.get_int("dataset.min_num_views_sampled")
    max_views = conf.get_int("dataset.max_num_views_sampled")
    inplane = conf.get_float("dataset.inplane_rot_aug_max_angle", default=None)
    tilt = conf.get_float("dataset.tilt_rot_aug_max_angle", default=None)
    if rng is None:
        rng = np.random.default_rng(conf.get_int("random_seed", default=0))

    test_scenes = create_scene_data_from_list(conf.get_list("dataset.test_set"), conf)
    validation_scenes = create_scene_data_from_list(conf.get_list("dataset.validation_set"), conf)
    train_scenes = create_scene_data_from_list(conf.get_list("dataset.train_set"), conf)

    datasets = {
        "train_set": ScenesDataSet(train_scenes, return_all=False,
                                   min_num_views_sampled=min_views,
                                   max_num_views_sampled=max_views,
                                   inplane_rot_aug_max_angle=inplane,
                                   tilt_rot_aug_max_angle=tilt, rng=rng),
        "train_set_for_eval": ScenesDataSet(train_scenes, return_all=True),
        "validation_set": ScenesDataSet(validation_scenes, return_all=True),
        "test_set": ScenesDataSet(test_scenes, return_all=True),
    }
    eval_data_loaders = {
        "train_loader_for_eval": SceneLoader(datasets["train_set_for_eval"], batch_size=1),
        "validation_loader": SceneLoader(datasets["validation_set"], batch_size=1),
        "test_loader": SceneLoader(datasets["test_set"], batch_size=1),
    }
    return datasets, eval_data_loaders


def train_model(conf, session: TrainingSession, train_set: ScenesDataSet, eval_data_loaders,
                phase: Phases, rng: Optional[np.random.Generator] = None):
    """Train ``session``'s model on ``train_set`` (reference
    multiple_scenes_learning.py:55-72): batches of ``dataset.batch_size``
    shuffled samples from ``dataset.dataloader_num_workers`` forked workers
    (0 or null: in this process), the loader's pool closed when training
    ends; writes ``train_stats.csv`` / ``.xlsx``. Returns (the weights
    {"final_model", "best_model"}, the train stats)."""
    assert phase == Phases.TRAINING
    train_loader = SceneLoader(
        train_set, batch_size=conf.get_int("dataset.batch_size"), shuffle=True,
        rng=rng if rng is not None else np.random.default_rng(
            conf.get_int("random_seed", default=0)),
        num_workers=conf.get_int("dataset.dataloader_num_workers", default=0) or 0)
    try:
        trained, train_stats = train(
            conf, train_loader, session, phase,
            train_loader_for_eval=eval_data_loaders["train_loader_for_eval"],
            val_loader=eval_data_loaders["validation_loader"],
            test_loader=eval_data_loaders["test_loader"], rng=rng)
    finally:
        train_loader.close()
    write_results(conf, train_stats.round(3), file_name="train_stats")
    return trained, train_stats


def eval_model(conf, session: TrainingSession, weights: Mapping[str, torch.Tensor],
               data_loaders, store_as_epoch: Optional[int], filename_prefix: str,
               rng: Optional[np.random.Generator] = None) -> Dict:
    """Evaluate ``weights`` (loaded into the session's model in place) on the
    training, validation and test sets with bundle adjustment and prediction
    dumps, writing ``<prefix>{train,val,test}_errors[_outlier_rate..].csv``
    (with ``train.outlier_injection_rate`` also an outlier-free pass of each;
    reference multiple_scenes_learning.py:75-99). Returns the tables."""
    outlier_injection_rate = conf.get_float("train.outlier_injection_rate", default=None)
    run_ba = conf.get_bool("ba.run_ba", default=True)
    stdout_log_eval_memory = conf.get_bool("memory.stdout_log_eval_memory_consumption",
                                           default=False)
    no_crash = conf.get_bool("memory.post_train_eval_no_crash_on_scene_exhausting_memory",
                             default=True)
    outlier_ids = get_additional_identifiers_for_outlier_injection(outlier_injection_rate)
    session.load_weights(weights)

    def evaluate(loader, ph, oir, ids):
        return epoch_evaluation(
            loader, session, None, conf, store_as_epoch, ph, outlier_injection_rate=oir,
            dump_and_plot_predictions=True, additional_identifiers=ids, bundle_adjustment=run_ba,
            log_memory_consumption=stdout_log_eval_memory,
            crash_on_scene_exhausting_memory=not no_crash, rng=rng)

    results = {}
    for loader_key, ph, name in (("train_loader_for_eval", Phases.TRAINING, "train_errors"),
                                 ("validation_loader", Phases.VALIDATION, "val_errors"),
                                 ("test_loader", Phases.TEST, "test_errors")):
        errors = evaluate(data_loaders[loader_key], ph, outlier_injection_rate, outlier_ids)
        write_results(conf, errors.round(3), file_name=filename_prefix + name,
                      additional_identifiers=outlier_ids)
        results[name] = errors
        if outlier_injection_rate is not None:
            write_results(conf, evaluate(data_loaders[loader_key], ph, None, []).round(3),
                          file_name=filename_prefix + name)
    return results


def optimization_all_test_scenes(conf, model: torch.nn.Module,
                                 weights: Mapping[str, torch.Tensor], phase: Phases,
                                 additional_identifier: Optional[str] = None,
                                 rng: Optional[np.random.Generator] = None,
                                 device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Fine-tune (or short-optimize) every test scene from ``weights``,
    loaded into ``model`` before each, in a single-scene session per scene
    (reference multiple_scenes_learning.py:102-136). The conf's fine-tune
    overrides, as the JAX package applies them: ``train.finetune_n_epochs``,
    ``train.finetune_lr`` with a constant schedule after
    ``train.finetune_lr_warmup_n_steps``, the dump intervals, and
    ``train.finetune_eval_interval`` written to ``eval.eval_interval`` (the
    key that is read; the reference writes the unread
    ``train.eval_interval``, msl.py:124); ``train.validation_metric``
    cleared (fine-tuning keeps no best model). Asserts before each scene
    that ``weights`` were not changed. Returns {scene: what
    ``train_model_single_scene`` returns}."""
    no_crash = conf.get_bool("memory.finetune_no_crash_on_scene_exhausting_memory", default=True)
    conf_test = conf.copy()
    conf_test.put("train.validation_metric", None)
    conf_test.put("train.n_epochs", conf.get_int("train.finetune_n_epochs"))
    conf_test.put("eval.eval_interval", conf.get_int("train.finetune_eval_interval"))
    conf_test.put("train.finetune_dump_model_interval",
                  conf.get_int("train.finetune_dump_model_interval", default=None))
    conf_test.put("train.finetune_dump_and_plot_pred_interval",
                  conf.get_int("train.finetune_dump_and_plot_pred_interval", default=None))
    conf_test.put("train.lr", conf.get_float("train.finetune_lr"))
    conf_test.put("train.lr_schedule.lr_warmup_n_steps",
                  conf.get_int("train.finetune_lr_warmup_n_steps", default=0))
    conf_test.put("train.lr_schedule.main_scheduler", "constant")

    initial = {k: v.detach().clone() for k, v in weights.items()}
    results = {}
    for scene in conf.get_list("dataset.test_set"):
        conf_test.put("dataset.scene", scene)
        # the weights must not have been changed by an earlier scene's
        # training (reference msl.py:134-135)
        assert all(torch.equal(initial[k], weights[k]) for k in initial)
        model.load_state_dict(dict(weights))  # in place, onto the model's device
        results[scene] = train_model_single_scene(
            conf_test, model, phase, additional_identifier=additional_identifier,
            crash_on_scene_exhausting_memory=not no_crash, rng=rng, device=device)
        gc.collect()
    return results
