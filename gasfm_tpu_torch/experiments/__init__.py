"""Experiment drivers: single-scene optimization (the multi-scene learning
driver is the next slice's)."""

from gasfm_tpu_torch.experiments.single_scene import train_model_single_scene

__all__ = ["train_model_single_scene"]
