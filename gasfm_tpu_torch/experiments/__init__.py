"""Experiment drivers: single-scene optimization and multi-scene learning."""

from gasfm_tpu_torch.experiments.multi_scene import (create_eval_dataloaders, eval_model,
                                                     optimization_all_test_scenes, train_model)
from gasfm_tpu_torch.experiments.single_scene import train_model_single_scene

__all__ = ["create_eval_dataloaders", "eval_model", "optimization_all_test_scenes",
           "train_model", "train_model_single_scene"]
