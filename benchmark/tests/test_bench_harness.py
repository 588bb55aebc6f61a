"""The harness end to end on the CPU at a small size: the reference
against the program's plain path, the comparison against planted faults,
the cell files found by name, and ``BENCHMARK.json`` against the
benchmark's contract."""

import json
import re
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from bench_helpers import small_cell
from benchmark import spec
from benchmark.check import NUMBERS
from benchmark.program import Program
from benchmark.reference.graph import build_graph
from benchmark.reference.train import model_class
from benchmark.run import measure, result_line
from benchmark.scene import generate
from benchmark.spec import REPO
from benchmark.weights import make_weights

SEED = 2**31 + 77
CELLS = ["gasfm.dense", "dpesfm.powerlaw", "gasfm.wide", "gasfm.powerlaw", "gasfm.large"]


def _weights(cell, seed=SEED):
    with torch.device("meta"):
        model = model_class(cell.config["reference"])(cell.config["conf"]["model"])
    return make_weights(model, seed, "cpu", cell.config.get("fixed_weights"))


@pytest.mark.parametrize("workload", ["gasfm.dense", "dpesfm.powerlaw"])
def test_reference_forward_matches_the_program_plain_path(workload):
    cell = small_cell(workload)
    scene = generate(cell.traffic, SEED)
    weights = _weights(cell)
    program = Program(cell.config, scene, weights, "cpu")
    graph = program.session.scene_graph(program.data)
    with torch.no_grad():
        got = program.session.model(graph.graph, plain=True)
        ref = model_class(cell.config["reference"])(cell.config["conf"]["model"])
        ref.load_state_dict(weights)
        want = ref(build_graph(scene.M, scene.Ns, "cpu"))
    for key in ("Ps_norm", "pts3D"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("workload", ["gasfm.dense", "dpesfm.powerlaw"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(workload, trace):
    cell = small_cell(workload)
    out = measure(cell, SEED, 0.3, trace, "cpu", time.perf_counter())
    assert out["correct"], out["numbers"]
    names = {m.name for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:  # no card: only the set-up spans have something to read
        assert set(out["metrics"]) == {"setup.graph_s", "setup.record_s"}
    else:
        assert set(out["metrics"]) == names
        assert out["steps"] >= 1 and out["metrics"]["step_ms"]["value"] > 0
    line = result_line(out, trace, "cpu")
    assert list(line)[-1] == "compared" and set(line["compared"]) == set(cell.limits)


def _unchanged_state(program):
    program.session.optimizer.apply = lambda grads, norm=None: None


def _half_the_edges(monkeypatch):
    from gasfm_tpu_torch.ops.kernels import fused_loss

    plain = fused_loss.fused_esfm_terms_plain

    def half(P_flat, Xt, graph, *args, **kw):
        h = graph.num_edges // 2
        part = SimpleNamespace(cam_idx=graph.cam_idx[:h], pt_idx=graph.pt_idx[:h],
                               uv=graph.uv[:h], num_edges=h)
        return plain(P_flat, Xt, part, *args, **kw)

    monkeypatch.setattr(fused_loss, "fused_esfm_terms_plain", half)


def _altered_loss(monkeypatch):
    from gasfm_tpu_torch import losses

    call = losses.ESFMLoss.__call__
    monkeypatch.setattr(losses.ESFMLoss, "__call__",
                        lambda self, *a, **kw: call(self, *a, **kw) * 1.01)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_the_edges", "altered_loss"])
@pytest.mark.parametrize("workload", ["gasfm.dense", "dpesfm.powerlaw"])
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    """The run with the chip's look skipped and the timed path broken: a
    step that leaves the state unchanged, a loss over half the
    observations, a loss altered where it is produced. (A cell of one chip
    has no exchange between chips to leave out.)"""
    cell = small_cell(workload)
    hook = None
    if fault == "unchanged_state":
        hook = _unchanged_state
    elif fault == "half_the_edges":
        _half_the_edges(monkeypatch)
    else:
        _altered_loss(monkeypatch)
    out = measure(cell, SEED, 0.2, False, "cpu", time.perf_counter(), program_hook=hook)
    assert not out["correct"], out["numbers"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric, each a new file, and new entries in BENCHMARK.json: the harness
    finds them by name and edits nothing."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = json.loads((REPO / "benchmark/configs/dpesfm.json").read_text())
    config["name"] = "dpesfm-small"
    config["conf"]["model"]["num_features"] = 16
    (tmp_path / "benchmark/configs/dpesfm-small.json").write_text(json.dumps(config))
    traffic = dict(json.loads((REPO / "benchmark/traffic/dense.json").read_text()),
                   n_views=12, n_points=80, expected_edges=None)
    (tmp_path / "benchmark/traffic/tiny.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/limits/dpesfm-small.tiny.json").write_text(
        (REPO / "benchmark/limits/dpesfm.powerlaw.json").read_text())
    (tmp_path / "benchmark/metrics/setup.total_s.py").write_text(
        "def read(r):\n    return sum(r.spans.values())\n")
    bench["configs"].append(dict(bench["configs"][1], name="dpesfm-small",
                                 file="benchmark/configs/dpesfm-small.json"))
    bench["workloads"].append({"name": "dpesfm-small.tiny", "config": "dpesfm-small",
                               "traffic": "tiny", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "setup.total_s", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "session",
                               "moves": "setup_s", "workloads": ["dpesfm-small.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (REPO / "benchmark").rglob("*.py")}

    cell = spec.load("dpesfm-small.tiny", root=tmp_path)
    assert [m.name for m in cell.per_layer][-1] == "setup.total_s"
    others = spec.load("gasfm.dense", root=tmp_path).per_layer
    assert "setup.total_s" not in [m.name for m in others]
    out = measure(cell, SEED, 0.2, True, "cpu", time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["setup.total_s"]["value"] > 0
    assert before == {p: p.read_bytes() for p in (REPO / "benchmark").rglob("*.py")}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    raw = (REPO / "BENCHMARK.json").read_text()
    bench = json.loads(raw)
    assert len(raw.encode()) <= 64 * 1024
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).exists()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (REPO / "benchmark/traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((REPO / "benchmark/limits" / f"{w['name']}.json").read_text())
        assert limits and set(limits) <= set(NUMBERS)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and (REPO / "benchmark/metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"])
        for key in ("why", "layer", "source"):
            assert key not in entry or 1 <= len(entry[key]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({*cells, *configs, *e2e, *(m["name"] for m in bench["per_layer"])}) == (
        len(cells) + len(configs) + len(e2e) + len(bench["per_layer"]))
    assert list(cells) == CELLS


class _Profile:
    """A stand-in for ``torch.profiler.profile`` whose windows catch the
    kernel launches listed in ``caught``, one list per window."""

    def __init__(self, caught):
        self.caught = iter(caught)

    def __call__(self, activities):
        self.events_ = [self._event(name, i) for i, name in enumerate(next(self.caught))]
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.events_

    @staticmethod
    def _event(name, i):
        from torch.autograd import DeviceType

        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               time_range=SimpleNamespace(start=10 * i, end=10 * i + 5))


@pytest.mark.parametrize("caught, launches", [
    ([["a", "b"], ["a"], ["a", "b"]], 2),  # agrees with a window before the last
    ([["a"], ["a", "b", "b"], ["b"], [], ["a", "b"], ["b", "b"], ["a", "a"], ["c"]], 3),
    ([[]] * 8, None),  # no window caught a launch
])
def test_a_traced_window_is_chosen_from_the_windows_taken(caught, launches, monkeypatch):
    import torch.profiler

    from benchmark import trace

    monkeypatch.setattr(torch.profiler, "profile", _Profile(caught))
    win = trace.traced_window(lambda: None, 2, lambda: None)
    assert (win and win.launches()) == launches
