"""The frozen yardstick: the scene generator, and the operation and byte
counts behind ``step.mfu`` and ``kernels.roofline``."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_helpers import SMALL_GASFM, small_cell
from benchmark import counts, roofline, spec
from benchmark.counts import dpesfm, gasfm
from benchmark.reference import gasfm as gasfm_reference
from benchmark.reference.graph import build_graph
from benchmark.reference.train import model_class
from benchmark.run import shape_of
from benchmark.scene import generate
from benchmark.spec import REPO
from benchmark.weights import make_weights

TRAFFIC = REPO / "benchmark" / "traffic"


@pytest.mark.parametrize("name, edges", [("dense", 115605), ("powerlaw", 70465),
                                         ("wide", 47383)])
def test_traffic_reproduces_the_scenes(name, edges):
    traffic = json.loads((TRAFFIC / f"{name}.json").read_text())
    assert traffic["expected_edges"] == edges
    a, b = generate(traffic, 2**31 + 11), generate(traffic, 2**31 + 11)
    c = generate(traffic, 5)
    assert a.num_edges == c.num_edges == edges
    assert np.array_equal(a.M, b.M) and np.array_equal(a.Ps, b.Ps)
    assert not np.array_equal(a.M, c.M)
    assert np.array_equal(a.M != 0, c.M != 0)  # the same observations, other positions


def test_large_traffic_layout():
    """The collection-scale scene's observations, from its layout alone."""
    from benchmark.scene import _visibility

    traffic = json.loads((TRAFFIC / "large.json").read_text())
    rng = np.random.default_rng(traffic["layout_seed"])
    rng.uniform(-1.5, 1.5, size=(traffic["n_points"], 3))
    vis = _visibility(rng, traffic["n_views"], traffic["n_points"], 0.75, "powerlaw",
                      traffic["powerlaw_alpha"])
    assert int(vis.sum()) == traffic["expected_edges"] == 804554
    assert vis.sum(axis=0).min() >= 2 and vis.sum(axis=1).min() == 172


def test_generator_refuses_a_wrong_edge_count():
    traffic = dict(json.loads((TRAFFIC / "dense.json").read_text()), n_views=12, n_points=60)
    with pytest.raises(AssertionError):
        generate(traffic, 1)


def test_roofline_bound():
    assert roofline.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e9, 134e9) == pytest.approx(2e-3)
    assert roofline.bound_of_calls([("a", 3.35e9, 0.0), ("b", 0.0, 67e9)]) == pytest.approx(2e-3)


def test_gasfm_model_flops_by_hand():
    conf = dict(SMALL_GASFM, view_head={"n_hidden_layers": 2},
                scenepoint_head={"n_hidden_layers": 2})
    # layer 0 8,448, layer 1 15,424 (its global query adapters: one linear,
    # 16 to 8; 16 to 16 is none), final aggregation 7,296, heads 5,264,
    # embedding 80: three times the forward, twice the embedding
    assert gasfm.model_flops(conf, dict(E=10, n=5, m=3)) == 3 * (36432 - 512) + 2 * 80


def test_dpesfm_model_flops_by_hand():
    conf = dict(num_features=4, num_blocks=1, block_size=2, view_head={"n_hidden_layers": 1},
                scenepoint_head={"n_hidden_layers": 1})
    assert dpesfm.model_flops(conf, dict(E=10, n=5, m=3)) == 2 * 304 + 3 * 608 + 3 * 800


@pytest.mark.parametrize("workload", ["gasfm.dense", "dpesfm.powerlaw"])
def test_model_flops_match_the_reference_linears(workload, monkeypatch):
    """The count against PyTorch's own count of the reference's matrix
    products, forward and backward, on a small scene."""
    cell = small_cell(workload)
    scene = generate(cell.traffic, 3)
    graph = build_graph(scene.M, scene.Ns, "cpu")
    model = model_class(cell.config["reference"])(cell.config["conf"]["model"])
    model.load_state_dict(make_weights(model, 3, "cpu"))
    # the count leaves recomputation out: each layer runs once
    monkeypatch.setattr(gasfm_reference, "checkpoint", lambda fn, *args, **kw: fn(*args))
    with FlopCounterMode(display=False) as counter:
        pred = model(graph)
        (pred["Ps_norm"].sum() + pred["pts3D"].sum()).backward()
    counts = __import__(cell.config["counts"], fromlist=["model_flops"])
    shape = dict(E=graph.num_edges, n=graph.num_pts, m=graph.num_cams)
    assert counts.model_flops(cell.config["conf"]["model"], shape) == counter.get_total_flops()


SMALL = dict(E=10, n=5, m=3, pt_deg=np.array([2, 2, 2, 2, 2]), cam_deg=np.array([4, 3, 3]),
             sms=1)


def test_kernel_bytes_by_hand():
    """Each input read once, each output written once, at a small shape."""
    assert counts.column_sum(6, 8) == ("column_sum_kernel", 4 * (48 + 8), 48.0)
    assert counts.gather_rows(3, 12, 10) == ("gather_rows_kernel", 4 * (36 + 120) + 40, 0.0)
    # (10, 4) rows summed into 5 points: rows, sums, offsets; the cameras
    # read their permutation too
    assert counts.segment_sum(10, 4, 5, SMALL["pt_deg"], False) == [
        ("segment_sum_kernel", 4 * (40 + 20) + 4 * 6, 40.0)]
    assert counts.segment_sum(10, 4, 3, SMALL["cam_deg"], True) == [
        ("segment_sum_kernel", 4 * (40 + 12) + 4 * (4 + 10), 40.0)]
    # a camera of 3,000 observations is cut into two parts and merged
    hub = counts.segment_sum(3000, 4, 1, np.array([3000]), True)
    assert [k for k, _, _ in hub] == ["segment_sum_kernel", "segment_sum_merge_kernel"]
    assert hub[1] == ("segment_sum_merge_kernel", 4 * (2 * 4 + 4), 8.0)
    assert counts.edge_combine(SMALL, 4) == [
        ("edge_combine_kernel", 4 * (80 + 9 * 4) + 4 * 20, 120.0)]
    # the first layer's prologue: e (10, 2) in, e_norm (10, 2), two (10, 4) out
    assert counts.frontend(SMALL, 2, 4, 4) == [("frontend_fwd_narrow_kernel", 4 * 10 * 12,
                                                10 * (20.0 + 32.0))]
    # a layer step 32 wide: en, skip, residual, update, its LayerNorm, both
    # source rows; the point and camera rows; two index rows
    step = counts.layer_step(SMALL, 32, 2, 32, 32, 32, raw=False)
    assert step == [("layer_step_fwd_tile_kernel", 4 * (10 * 194 + 8 * 32) + 4 * 20,
                     10 * (2.0 * 32 * 34 + 128 + 320 + 2.0 * 32 * 64))]
    # the dual core at 32 wide: both edge streams, both query tables, the
    # offsets and the camera permutation in; both outputs and the softmax
    # residuals out; no segment is long
    dual = counts.dual_attend(SMALL, 32, 32, 4)
    assert dual == [("dual_attend_kernel", 4 * (640 + 256) + 4 * (10 + 10)
                     + 4 * (256 + 8 * 8), 8.0 * 10 * 64)]


def test_roofline_reader_matches_traced_launches():
    """``kernels.roofline`` reads the counted launches against the traced
    ones by name, and reads nothing where they differ."""
    from benchmark.spec import _load_reader

    read = _load_reader(REPO / "benchmark/metrics/kernels.roofline.py")
    launches = [("segment_sum_kernel", 3.35e6, 0.0), ("segment_sum_kernel", 3.35e6, 0.0),
                ("column_sum_kernel", 0.0, 67e6)]
    kernels = {"void gasfm::segment_sum_kernel<4, 8, false>(float const*)": [4, 8e-6],
               "gasfm::column_sum_kernel(float const*, int, int, float*)": [2, 2e-6],
               "ampere_sgemm_64x32": [10, 1.0]}

    def reading(k, counted=launches):
        window = SimpleNamespace(steps=2, kernels=k)
        return read(SimpleNamespace(window=window, kernel_launches=counted))

    # bound 2 us + 1 us per step over 5 us per step
    assert reading(kernels) == pytest.approx(60.0)
    assert reading(dict(kernels, **{"gasfm::new_kernel(int)": [2, 1e-6]})) is None
    assert reading(dict(kernels, **{"gasfm::column_sum_kernel(float const*, int, int, "
                                    "float*)": [4, 2e-6]})) is None
    assert reading(kernels, launches[:2]) is None


# launches per step of the port's kernels, by the profiler on an H100 (the
# dense scene's merged step; the wide scene's unfused one; DPESFM's)
MERGED_DENSE = {"frontend_fwd_narrow_kernel": 1, "dual_attend_kernel": 10,
                "dual_attend_merge_kernel": 10, "layer_step_fwd_tile_kernel": 9,
                "esfm_terms_kernel": 1, "gather_rows_kernel": 3, "esfm_terms_bwd_kernel": 1,
                "dual_attend_bwd_kernel": 10, "dual_bwd_merge_kernel": 10,
                "column_sum_kernel": 20, "layer_step_bwd_tile_kernel": 9,
                "segment_sum_kernel": 18, "frontend_bwd_narrow_kernel": 1}
UNFUSED_WIDE = {"attend_point_kernel": 10, "attend_merge_kernel": 10, "gather_rows_kernel": 33,
                "segment_sum_kernel": 48, "edge_combine_kernel": 9, "esfm_terms_kernel": 1,
                "esfm_terms_bwd_kernel": 1, "attend_point_bwd_kernel": 10,
                "attend_bwd_merge_kernel": 10, "column_sum_kernel": 19}
DPESFM_POWERLAW = {"segment_sum_kernel": 14, "edge_combine_kernel": 3, "esfm_terms_kernel": 1,
                   "gather_rows_kernel": 9, "esfm_terms_bwd_kernel": 1, "column_sum_kernel": 3}
FLAGSHIP = dict(num_layers=9, n_heads=4, n_feat_proj=32, n_feat_scenepoint=64,
                n_feat_view=1024, n_feat_global=2048)


def _tally(launches):
    return {k: sum(1 for n, _, _ in launches if n == k) for k, _, _ in launches}


@pytest.mark.parametrize("workload, want", [("gasfm.dense", MERGED_DENSE),
                                             ("gasfm.wide", UNFUSED_WIDE),
                                             ("dpesfm.powerlaw", DPESFM_POWERLAW)])
def test_kernel_launches_match_the_trace(workload, want):
    """A step's counted launches per kernel name against the profiler's
    count on the card: the merged path, the unfused path, DPESFM."""
    cell = spec.load(workload)
    shape = shape_of(generate(cell.traffic, 7), torch.device("cpu"))
    model = cell.config["conf"]["model"]
    family = gasfm if "num_layers" in model else dpesfm
    if family is gasfm:
        assert gasfm.merged(model, shape) == (workload == "gasfm.dense")
    launches = family.kernel_launches(model, shape)
    assert _tally(launches) == want
    assert all(b > 0 for _, b, _ in launches)
