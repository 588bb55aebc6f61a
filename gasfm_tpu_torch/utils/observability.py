"""Observability: the TensorBoard event writer, result tables, prediction
dumps, the source snapshot and a conf-gated profiler window.

Counterpart of the JAX package's utils/observability.py (reference
code/utils/general_utils.py:16-77 and the TensorBoard tag scheme of
code/train.py:22-46, 272-369), without pandas or tensorboard: results are
:class:`~gasfm_tpu_torch.utils.tables.Table` s written as CSV (what pandas'
``to_csv(na_rep="NULL")`` writes, merged by ``Scene`` in append mode) with
an ``.xlsx`` twin, and scalars go to an event file of the port's own
(:class:`~gasfm_tpu_torch.utils.events.EventWriter`). The tag scheme is the
JAX package's.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np

from gasfm_tpu_torch.utils import paths
from gasfm_tpu_torch.utils.events import EventWriter
from gasfm_tpu_torch.utils.phases import Phases
from gasfm_tpu_torch.utils.tables import Table

_tb_writer: Optional[EventWriter] = None


def get_tb_writer(conf) -> EventWriter:
    """The process-wide event writer, made on first use in the experiment's
    ``tb/`` directory (reference general_utils.py:16-23)."""
    global _tb_writer
    if _tb_writer is None:
        _tb_writer = EventWriter(paths.path_to_tb_events(conf))
    return _tb_writer


@atexit.register
def reset_tb_writer() -> None:
    """Close the event writer (its file complete on disk); the next
    :func:`get_tb_writer` opens a new one."""
    global _tb_writer
    if _tb_writer is not None:
        _tb_writer.close()
    _tb_writer = None


class ProfilerWindow:
    """A ``torch.profiler`` trace of a window of training epochs, gated by
    the conf: ``observability.profile_start_epoch`` (unset: every method does
    nothing) and ``observability.profile_n_epochs`` (default 1). The trace
    (host and CUDA activity) is written as a Chrome trace to
    ``<tb events>/profile/``, the JAX package's ``jax.profiler`` window's
    place. On the card the window opens and closes on a synchronised device,
    and its close prints the window's wall time, the device's kernel time in
    it (the sum over kernels, as ``tools/profile_forward.py`` counts it) and
    their ratio, the busy share."""

    def __init__(self, conf):
        self.start = conf.get_int("observability.profile_start_epoch", default=None)
        self.n_epochs = conf.get_int("observability.profile_n_epochs", default=1) or 1
        self.logdir = (os.path.join(paths.path_to_tb_events(conf), "profile")
                       if self.start is not None else None)
        self._prof = None

    @staticmethod
    def _sync() -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def maybe_start(self, epoch: int) -> None:
        if self.start is not None and epoch == self.start and self._prof is None:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._first = epoch
            self._sync()
            self._t0 = time.perf_counter()

    def maybe_stop(self, epoch: int) -> None:
        """Stop after the last epoch of the window (inclusive)."""
        if self._prof is not None and epoch >= self.start + self.n_epochs - 1:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            from torch.autograd import DeviceType

            self._sync()
            wall_ms = 1e3 * (time.perf_counter() - self._t0)
            self._prof.__exit__(None, None, None)
            kernels = [e for e in self._prof.events() if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)]
            device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
            path = os.path.join(self.logdir, f"trace_epoch{self._first + 1:06d}.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            print(f"[profiler] epochs {self._first + 1}..{self._first + self.n_epochs}: wall "
                  f"{wall_ms:.3f} ms, device kernel time {device_ms:.3f} ms in {len(kernels)} "
                  f"kernels, busy share {device_ms / wall_ms:.4f}; trace written to {path}")


def dump_predictions(conf, pred_dict: Dict, scene: str, phase, epoch=None,
                     additional_identifiers=None) -> str:
    """npz prediction dumps (reference general_utils.py:53-58)."""
    path = paths.path_to_predictions(
        conf, phase, epoch=epoch, scene=scene, additional_identifiers=additional_identifiers
    )
    clean = {k: v for k, v in pred_dict.items() if v is not None}
    np.savez(path + ".npz", **clean)
    return path + ".npz"


def write_results(conf, table: Table, file_name: str = "Results", additional_identifiers=None,
                  append: bool = False) -> str:
    """``<exp>/<file_name>[_ids].csv`` and its ``.xlsx`` twin (reference
    general_utils.write_results, general_utils.py:61-77). With ``append``
    the rows of an existing CSV come first (the index kept, columns joined
    in order of first appearance)."""
    from gasfm_tpu_torch.utils.xlsx import write_xlsx

    exp_path = paths.path_to_exp(conf)
    file_name = "_".join([file_name] + list(additional_identifiers or []))
    path = os.path.join(exp_path, f"{file_name}.csv")
    if append and os.path.exists(path):
        table = Table.read_csv(path).concat(table)
    table.to_csv(path, na_rep="NULL")
    write_xlsx(os.path.join(exp_path, f"{file_name}.xlsx"), table)
    return path


def log_code(conf) -> None:
    """Copy the package's source into ``<exp>/code/gasfm_tpu_torch`` (no
    build outputs, caches or shared libraries) and the conf into
    ``<exp>/code/exp.conf.json`` (reference general_utils.log_code,
    general_utils.py:26-50)."""
    code_path = paths.path_to_code_logs(conf)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(code_path, os.path.basename(pkg_root))
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(pkg_root, dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "*.so", "*.o"))
    with open(os.path.join(code_path, "exp.conf.json"), "w") as f:
        json.dump(conf.to_dict(), f, indent=2, default=str)


# ---------------------------------------------------------------------------
# TensorBoard tags (reference train.py:22-46 and train.py:272-369)
# ---------------------------------------------------------------------------


def tb_log_train_step(
    tb_writer, batch_idx: int, signal_name: str, signal_val, phase: Phases,
    additional_identifiers: Optional[List[str]] = None, scene: Optional[str] = None,
):
    additional_identifiers = list(additional_identifiers or [])
    if phase == Phases.TRAINING:
        main_tag = f"{phase.name}-all-scenes" if scene is None else f"{phase.name}-per-scene"
    else:
        assert phase in (Phases.FINE_TUNE, Phases.SHORT_OPTIMIZATION, Phases.OPTIMIZATION)
        assert scene is not None
        main_tag = f"{phase.name}-train"
    tag = [main_tag] + additional_identifiers
    if scene is not None:
        tag.append("".join(scene.split()))
    tag += ["batch", signal_name]
    tb_writer.add_scalar("/".join(tag), signal_val, global_step=batch_idx + 1)


def eval_metric_columns(conf, include_post_ba_metrics: bool) -> List[str]:
    """The per-epoch metric battery logged to TensorBoard (reference
    train.py:280-340)."""
    depth_head = conf.get_bool("model.depth_head.enabled", default=False)
    view_head = conf.get_bool("model.view_head.enabled", default=False)
    scenepoint_head = conf.get_bool("model.scenepoint_head.enabled", default=False)
    explicit = view_head and scenepoint_head
    calc_backproj = conf.get_bool("eval.calc_reprojerr_with_gtposes_for_depth_pred", default=False)

    cols: List[str] = []
    if calc_backproj:
        cols += [
            "repro_backproj_rnd_gt_2view",
            "repro_backproj_depth_norm_mean_rnd_gt_2view",
            "repro_backproj_depth_norm_min_rnd_gt_2view",
            "repro_backproj_depth_norm_max_rnd_gt_2view",
        ]
        cols += [f"repro_backproj_depth_norm_q{q:02d}_rnd_gt_2view" for q in [10, 25, 50, 75, 90]]
    if depth_head:
        for prefix in ("depth_pred_norm", "depth_gt_norm"):
            cols += [f"{prefix}_mean", f"{prefix}_min", f"{prefix}_max"]
            cols += [f"{prefix}_q{q:02d}" for q in [10, 25, 50, 75, 90]]
        cols += ["depth_pred_err_mean"]
    if explicit:
        cols += ["our_repro", "triangulated_repro"]
        if conf.get_bool("dataset.calibrated"):
            cols += [
                "t_err_mean", "t_err_med", "R_err_mean", "R_err_med",
                "cam_centers_std", "cam_centers_gt_std",
            ]
        if include_post_ba_metrics:
            cols += ["repro_ba"]
            if conf.get_bool("dataset.calibrated"):
                cols += ["t_err_ba_mean", "t_err_ba_med", "R_err_ba_mean", "R_err_ba_med"]
        cols += [
            "fraction_views_neg_depth_for_any_point",
            "fraction_points_neg_depth_in_any_view",
            "total_fraction_points_neg_depth",
            "point_depth_mean", "point_depth_min", "point_depth_max",
        ]
    return cols


def tb_log_eval_step(
    conf, tb_writer, epoch: int, validation_errors: Table,
    phase: Phases = Phases.VALIDATION, additional_identifiers=None, scene=None,
    include_post_ba_metrics: bool = False,
):
    from gasfm_tpu_torch.train.loop import aggregate_val_metric

    additional_identifiers = list(additional_identifiers or [])
    for metric in eval_metric_columns(conf, include_post_ba_metrics):
        if phase == Phases.VALIDATION:
            main_tag = f"{phase.name}-scene-avg" if scene is None else f"{phase.name}-per-scene"
        elif phase == Phases.TRAINING:
            main_tag = (f"{phase.name}-eval-scene-avg" if scene is None
                        else f"{phase.name}-eval-per-scene")
        else:
            assert phase in (Phases.FINE_TUNE, Phases.SHORT_OPTIMIZATION, Phases.OPTIMIZATION)
            assert scene is not None
            main_tag = f"{phase.name}-eval"
        tag = [main_tag] + additional_identifiers
        if scene is not None:
            tag.append("".join(scene.split()))
        tag += ["epoch", metric]
        try:
            val = aggregate_val_metric(validation_errors, metric_column=metric, scene=scene)
        except KeyError:
            continue
        tb_writer.add_scalar("/".join(tag), val, global_step=epoch + 1)
    tb_writer.flush()
