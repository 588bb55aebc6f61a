"""Dataset of scenes and its batched loader.

Counterpart of ``ScenesDataSet`` and ``SceneLoader`` in the JAX package's
data/dataset.py (:103, :171; reference ScenesDataSet.py:5-51 with the
trivial list collate): the single-scene drivers' form, every scene whole
(``return_all=True``), in order, in this process. With ``return_all`` the
dataset hands back the same :class:`SceneData` object at every epoch, so a
session's per-scene graph and its CUDA-graph recordings are reused across
epochs.

View sampling (``return_all=False``), the rotational-homography
augmentation, shuffling, the prefetch thread and the worker pool belong to
the multi-scene slice (slice 5) and raise ``NotImplementedError`` until
then.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from gasfm_tpu_torch.data.scene import SceneData

_SLICE5 = "is not ported yet (the multi-scene learning slice, slice 5)"


class ScenesDataSet:
    def __init__(
        self,
        data_list: List[SceneData],
        return_all: bool,
        min_num_views_sampled: int = 10,
        max_num_views_sampled: int = 30,
        inplane_rot_aug_max_angle: Optional[float] = None,
        tilt_rot_aug_max_angle: Optional[float] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        if not return_all:
            raise NotImplementedError(f"view sampling (return_all=False) {_SLICE5}")
        if inplane_rot_aug_max_angle is not None or tilt_rot_aug_max_angle is not None:
            raise NotImplementedError(f"the rotational-homography augmentation {_SLICE5}")
        self.data_list = list(data_list)
        self.return_all = return_all

    def __getitem__(self, item: int) -> SceneData:
        return self.data_list[item]

    def __len__(self) -> int:
        return len(self.data_list)


class SceneLoader:
    """Lists of ``batch_size`` scenes (the last may be short), in the
    dataset's order."""

    def __init__(
        self,
        dataset: ScenesDataSet,
        batch_size: int = 1,
        shuffle: bool = False,
        prefetch: int = 0,
        rng: Optional[np.random.Generator] = None,
        num_workers: int = 0,
    ):
        if shuffle or prefetch > 0 or num_workers > 0:
            raise NotImplementedError(f"shuffling, the prefetch thread and the worker pool "
                                      f"{_SLICE5}")
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[List[SceneData]]:
        for i in range(0, len(self.dataset), self.batch_size):
            yield [self.dataset[j] for j in range(i, min(i + self.batch_size, len(self.dataset)))]
