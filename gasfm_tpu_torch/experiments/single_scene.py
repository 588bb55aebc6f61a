"""Single-scene optimization / fine-tuning driver.

Counterpart of the JAX package's experiments/single_scene.py (reference
code/single_scene_optimization.py:15-123): build the scene, train a session
on it, evaluate the final weights with bundle adjustment, tolerate a device
out-of-memory error with a row of NaNs, and append the scene's row, joined
with the train stats, to the results table. Where the JAX package evaluates
the returned weights in a second session, the port evaluates them in the
training session itself (its model restored in place from the
``final_model`` copy): its recorded forward replays, and no second model or
recording is made.

On a mesh (``mesh``, this rank's; the CLI launches the ranks) every rank runs
this driver on the same scene and conf; only rank 0 evaluates the metrics,
runs BA and writes the results, and the other ranks return None for the
evaluation's table.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from gasfm_tpu_torch.data.dataset import SceneLoader, ScenesDataSet
from gasfm_tpu_torch.data.loaders import create_scene_data
from gasfm_tpu_torch.eval.metrics import get_dummy_errors
from gasfm_tpu_torch.train.loop import (TrainingSession, _is_oom_error, curriculum_epochs,
                                        epoch_evaluation, eval_errors_list2df,
                                        get_dummy_train_stats, train)
from gasfm_tpu_torch.utils.observability import write_results
from gasfm_tpu_torch.utils.paths import get_additional_identifiers_for_outlier_injection
from gasfm_tpu_torch.utils.tables import Table


def _write_train_res(conf, errors: Table, train_stats: Table, file_name: str, ids) -> None:
    errors = errors.drop("Mean")
    if len(train_stats) != len(errors):
        raise ValueError(f"{len(train_stats)} train-stats rows for {len(errors)} scenes")
    stats = Table(errors.index_name, train_stats.columns,
                  [(scene, row) for scene, (_, row) in zip(errors.index, train_stats.rows)])
    write_results(conf, errors.join(stats).round(3), file_name=file_name,
                  additional_identifiers=ids, append=True)


def train_model_single_scene(
    conf,
    model: torch.nn.Module,
    phase,
    additional_identifier: Optional[str] = None,
    crash_on_scene_exhausting_memory: bool = True,
    rng: Optional[np.random.Generator] = None,
    device: Optional[Union[str, torch.device]] = None,
    capture: Optional[bool] = None,
    mesh=None,
):
    """Optimize ``model`` (in place) on the conf's scene for ``phase`` on
    ``device`` (``cuda`` unless the caller names another; the steps and the
    forward recorded as CUDA graphs there, see ``TrainingSession``), then
    evaluate it and write ``final_train_errors_<PHASE>[_id].csv`` / ``.xlsx``
    (with ``train.outlier_injection_rate`` the evaluation with outliers
    under the rate's identifier, then an outlier-free one). The session is
    closed before returning. Returns (the trained weights {"final_model":
    state_dict on the CPU}, the train stats, the final evaluation's
    table)."""
    additional_identifiers = [] if additional_identifier is None else [additional_identifier]
    outlier_injection_rate = conf.get_float("train.outlier_injection_rate", default=None)
    outlier_ids = get_additional_identifiers_for_outlier_injection(outlier_injection_rate)
    run_ba = conf.get_bool("ba.run_ba", default=True)
    stdout_log_eval_memory = conf.get_bool("memory.stdout_log_eval_memory_consumption",
                                           default=False)
    no_crash_post_train = conf.get_bool(
        "memory.post_train_eval_no_crash_on_scene_exhausting_memory", default=True)
    if rng is None:
        rng = np.random.default_rng(conf.get_int("random_seed", default=0))

    scene_data = create_scene_data(conf)
    scene_loader = SceneLoader(ScenesDataSet([scene_data], return_all=True), batch_size=1,
                               shuffle=False, prefetch=0)
    session = TrainingSession.from_conf(
        conf, model, milestone_shift=curriculum_epochs(conf, phase, scene_data), device=device,
        capture=capture, mesh=mesh)
    trained, train_stats = train(conf, scene_loader, session, phase,
                                 additional_identifier=additional_identifier, rng=rng)

    def evaluate(oir, ids):
        return epoch_evaluation(
            scene_loader, session, trained["final_model"], conf, -1, phase,
            outlier_injection_rate=oir, dump_and_plot_predictions=True,
            additional_identifiers=ids, bundle_adjustment=run_ba,
            log_memory_consumption=stdout_log_eval_memory,
            crash_on_scene_exhausting_memory=not no_crash_post_train, rng=rng,
        )

    outlier_free = None
    try:
        final_train_errors = evaluate(outlier_injection_rate, additional_identifiers + outlier_ids)
        if outlier_injection_rate is not None:
            outlier_free = evaluate(None, additional_identifiers)
        if conf.get_string("train.validation_metric", default=None) is not None:
            assert "best_model" in trained  # a single-scene phase keeps no best model
    except Exception as e:  # noqa: BLE001 - the reference's OOM tolerance (sso.py:50-78)
        if not _is_oom_error(e) or crash_on_scene_exhausting_memory:
            raise
        print(f"Ran out of memory when fine-tuning on {scene_data.scene_name}.")
        errors = get_dummy_errors(conf, run_ba)
        errors["Inference time"] = float("nan")
        errors["Scene"] = scene_data.scene_name
        final_train_errors = eval_errors_list2df([errors])
        outlier_free = None
        train_stats = get_dummy_train_stats()
    writer = session.is_writer
    session.close()
    if not writer:
        return trained, train_stats, None

    _write_train_res(conf, final_train_errors, train_stats, f"final_train_errors_{phase.name}",
                     additional_identifiers + outlier_ids)
    if outlier_free is not None:
        _write_train_res(conf, outlier_free, train_stats, f"final_train_errors_{phase.name}",
                         additional_identifiers)
    return trained, train_stats, final_train_errors
