"""The control on the card: the reference computed with TF32 matrix
products (the nearest precision below the configurations' float32), put in
the program's place, is not correct by the cell's limits. At the cells'
own sizes this is ``python -m benchmark.calibrate``; here at two layers on
a scene of a few thousand observations."""

import pytest
import torch

from bench_helpers import small_cell
from benchmark.check import gaps, judge
from benchmark.reference.graph import build_graph
from benchmark.reference.train import train_steps
from test_bench_harness import _weights
from benchmark.scene import generate


@pytest.mark.card
@pytest.mark.parametrize("workload", ["gasfm.dense", "dpesfm.powerlaw", "gasfm.wide",
                                      "gasfm.powerlaw", "gasfm.large"])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_the_control_is_not_correct(card, workload, seed):
    cell = small_cell(workload, n_views=64, n_points=1500)
    if "num_layers" in cell.config["conf"]["model"]:  # the published widths, two layers
        cell.config["conf"]["model"].update(num_layers=2, n_feat_proj=32, n_feat_scenepoint=64,
                                            n_feat_view=1024, n_feat_global=2048, n_heads=4)
    else:
        cell.config["conf"]["model"]["num_features"] = 256
    scene = generate(cell.traffic, seed)
    graph = build_graph(scene.M, scene.Ns, card)
    weights = {k: v.to(card) for k, v in _weights(cell, seed).items()}
    ref = train_steps(cell.config, graph, weights)
    skip = cell.config.get("two_wide_stream_leaves", ())
    assert judge(gaps(train_steps(cell.config, graph, weights), ref, skip), cell.limits)
    control = train_steps(cell.config, graph, weights, tf32=True, dtype=torch.float32)
    assert not judge(gaps(control, ref, skip), cell.limits)
