"""The system under test: the port's single-scene training loop.

The only module of the benchmark that imports the program. It builds the
session the way ``experiments/single_scene.py`` does (``TrainingSession.
from_conf`` on the configuration's conf, a ``SceneLoader`` of one scene,
``curriculum_epochs`` for the schedule's shift), loads the benchmark's
weights, and drives ``train.loop.epoch_train``: one-batch epochs with
``keep_last`` / ``carried`` and no TensorBoard writer, as ``train`` runs
them between interim evaluations.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def missing() -> Optional[str]:
    """Why the program cannot be imported here, or None."""
    try:
        import gasfm_tpu_torch  # noqa: F401
    except ImportError as e:
        return str(e)
    return None


class Program:
    def __init__(self, config: dict, scene, weights: Dict[str, torch.Tensor], device):
        from gasfm_tpu_torch.config.hocon import ConfigFactory
        from gasfm_tpu_torch.data.dataset import SceneLoader, ScenesDataSet
        from gasfm_tpu_torch.data.scene import SceneData
        from gasfm_tpu_torch.models import get_model
        from gasfm_tpu_torch.train.loop import TrainingSession, curriculum_epochs, epoch_train
        from gasfm_tpu_torch.utils.phases import Phases

        self._epoch_train = epoch_train
        self.phase = Phases.OPTIMIZATION
        self.device = torch.device(device)
        self.conf = ConfigFactory.from_dict(config["conf"])
        self.data = SceneData(scene.M, scene.Ns, scene.Ps, scene.name,
                              calibrated=self.conf.get_bool("dataset.calibrated"))
        self.loader = SceneLoader(ScenesDataSet([self.data], return_all=True), batch_size=1,
                                  shuffle=False, prefetch=0)
        with torch.device(self.device):  # the weights are overwritten below
            model = get_model(self.conf)
        capture = None if self.device.type == "cuda" else False
        self.session = TrainingSession.from_conf(
            self.conf, model, milestone_shift=curriculum_epochs(self.conf, self.phase, self.data),
            device=self.device, capture=capture)
        self.session.load_weights(weights)
        self.rng = np.random.default_rng(self.conf.get_int("random_seed", default=0))
        self.n_updates = 0
        self.epoch = 0
        self.carried: Optional[dict] = None

    def graph(self) -> None:
        """The scene's graph: the host build and the upload."""
        self.session.scene_graph(self.data)

    def step(self) -> dict:
        """One epoch of one batch; returns the step's unread scalars."""
        self.n_updates, _, _, _, self.carried = self._epoch_train(
            self.conf, self.session, self.loader, self.n_updates, self.epoch, self.phase, None,
            additional_identifiers=[], scene=self.data.scene_name, prev_n_batches=self.epoch,
            tb_log_train_per_scene=None, rng=self.rng, carried=self.carried, keep_last=True)
        self.epoch += 1
        return self.carried

    @staticmethod
    def scalars(carried: dict) -> List[float]:
        """(loss, our_repro, global gradient norm) of a step, waited for."""
        return carried["scalars"].get()

    def named_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.session.model.named_parameters())

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moments by parameter name (zeros where Adam holds
        none)."""
        state = self.session.optimizer.adam.state
        return {k: state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                for k, p in self.named_params().items()}

    def close(self) -> None:
        self.session.close()
        self.session = self.loader = self.data = self.carried = None
