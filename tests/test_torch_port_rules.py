"""Rules of the PyTorch/CUDA port (gasfm_tpu_torch).

- It stands alone: importing every module of the package, and chip_smoke.py
  as a module, loads neither JAX nor any module of the JAX package, nor
  pandas, tensorboard or matplotlib (none of them is on the H100 machine);
  its bundle-adjustment solver is the JAX package's source, byte for byte.
- Its entry points run on CUDA unless told otherwise, and raise — never
  fall back to the CPU quietly — when no GPU is present.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
import gasfm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gasfm_tpu_torch.__path__, "gasfm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gasfm_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
for new in ("ops.kernels.segment_kernels", "ops.kernels.fused_update", "ops.edge_update",
            "models.set_of_set", "ops.kernels.fused_attn", "ops.kernels.fused_proj_update",
            "geometry.triangulation", "tools.bench", "config.hocon", "config", "data.loaders",
            "main", "data.dataset", "geometry.alignment", "ba.drivers", "ba.native_lib",
            "ba.packing", "experiments.single_scene", "utils.observability", "utils.tables",
            "utils.events", "utils.paths", "utils.phases", "utils.plotting", "utils.xlsx",
            "data.sampling", "data.augmentation", "data.outliers", "experiments.multi_scene"):
    assert "gasfm_tpu_torch." + new in names, new
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


NO_HOST_LIBRARIES = r"""
import importlib, importlib.util, pkgutil, sys
import gasfm_tpu_torch
for m in pkgutil.walk_packages(gasfm_tpu_torch.__path__, "gasfm_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from gasfm_tpu_torch.main import parse_args
parse_args(["single-scene-optim", "--conf", "synth/optim_synth_gasfm.conf"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("pandas", "tensorboard", "matplotlib", "tensorflow"))
assert not bad, bad
"""


def test_port_imports_no_pandas_tensorboard_or_matplotlib():
    proc = subprocess.run([sys.executable, "-c", NO_HOST_LIBRARIES], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ba_solver_is_the_jax_packages_source_byte_for_byte():
    port = REPO / "gasfm_tpu_torch" / "ba" / "native" / "ba_solver.cpp"
    assert port.read_bytes() == (REPO / "gasfm_tpu" / "ba" / "native" / "ba_solver.cpp").read_bytes()


def _tiny_model():
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet

    return GraphAttnSfMNet(num_layers=1, n_heads=2, n_feat_proj=8, n_feat_scenepoint=8,
                           n_feat_view=8, n_feat_global=8)


@pytest.mark.parametrize("entry", ["session", "graph", "cli", "multi-scene-cli"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry, tmp_path):
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.losses import ESFMLoss
    from gasfm_tpu_torch.main import main
    from gasfm_tpu_torch.train.loop import TrainingSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
    data = generate_synthetic_scene(n_views=6, n_points=60, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "session":
            TrainingSession(_tiny_model(), ESFMLoss())
        elif entry == "graph":
            data.to_scene_graph()
        elif entry == "cli":
            main(["single-scene-optim", "--conf", "synth/optim_synth_dpesfm.conf"])
        else:
            main(["multi-scene-learning", "--conf", "synth/learning_synth_gasfm.conf"])
    assert not list(tmp_path.iterdir())  # the CLI raised before writing anything
    # Asking for the CPU explicitly works.
    session = TrainingSession(_tiny_model(), ESFMLoss(), device="cpu")
    pred = session.forward(data.to_scene_graph(device="cpu"))
    assert pred["Ps_norm"].shape == (6, 3, 4)


def test_kernel_wrappers_raise_on_cuda_operands_they_cannot_take():
    """A wrapper given a tensor that is not float32 on a CUDA device raises
    before any launch (here: a float64 tensor claiming CUDA is impossible on
    the CPU, so the validation helper is exercised directly)."""
    from gasfm_tpu_torch.ops.kernels import build

    with pytest.raises(TypeError, match="float32 CUDA tensor"):
        build.cuda_f32("x", torch.zeros(3))
    with pytest.raises(TypeError, match="int32 CUDA tensor"):
        build.cuda_i32("ids", torch.zeros(3, dtype=torch.int32))


def test_new_kernel_wrappers_raise_on_operands_they_cannot_take():
    """The segment-sum, gather and edge-combine launchers check their
    operands before any launch: a width above 256 or an unknown side is a
    ValueError, a tensor that is not on a CUDA device a TypeError — never a
    quiet plain-version fallback."""
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.ops.kernels import fused_update as fu
    from gasfm_tpu_torch.ops.kernels import segment_kernels as sk

    graph = generate_synthetic_scene(n_views=6, n_points=60, seed=0).to_scene_graph(
        device="cpu").graph
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    with pytest.raises(ValueError, match="1 <= D <= 256"):
        sk.segment_sum_forward(torch.zeros(E, 257), graph, "point")
    with pytest.raises(ValueError, match="side must be one of"):
        sk.segment_sum(torch.zeros(E, 4), graph, "global")
    with pytest.raises(TypeError, match="float32 CUDA tensor"):
        sk.segment_sum_forward(torch.zeros(E, 4), graph, "camera")
    with pytest.raises(TypeError, match="float32 CUDA tensor"):
        sk.gather_rows_forward(torch.zeros(n, 4), graph, "point")
    with pytest.raises(ValueError, match="width 257"):
        fu.edge_combine_forward(torch.zeros(E, 257), torch.zeros(n, 257), torch.zeros(m, 257),
                                torch.zeros(1, 257), graph)
    with pytest.raises(TypeError, match="float32 CUDA tensor"):
        fu.fused_edge_combine_bwd(torch.zeros(E, 8), graph)


def test_projection_update_launchers_raise_on_operands_they_cannot_take():
    """The projection update's launchers, forward and backward, check the
    widths the kernel takes (d_in, d2, De <= 32, d_in + d2 <= 64) and the
    operands' device before any launch."""
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.ops.kernels import fused_proj_update as fpu

    graph = generate_synthetic_scene(n_views=6, n_points=60, seed=0).to_scene_graph(
        device="cpu").graph
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams

    def args(d_in, d2, De):
        return (torch.zeros(E, d_in), torch.zeros(E, d2) if d2 else None, None,
                torch.zeros(De, d_in + d2), torch.zeros(De), torch.zeros(n, De),
                torch.zeros(m, De), torch.zeros(1, De), graph)

    with pytest.raises(ValueError, match="d_in, d2, De <= 32"):
        fpu.projection_update_forward(*args(33, 2, 32))
    with pytest.raises(ValueError, match="d_in, d2, De <= 32"):
        fpu.projection_update_forward(*args(32, 2, 64))
    with pytest.raises(TypeError, match="float32 CUDA tensor"):
        fpu.projection_update_forward(*args(32, 2, 32))
    with pytest.raises(TypeError, match="float32 CUDA tensor"):
        fpu.projection_update_bwd(torch.zeros(E, 32), torch.zeros(E, 32), None,
                                  torch.zeros(32, 32), graph)


def test_kernel_device_time_raises_on_a_window_without_cuda_events(monkeypatch):
    """``device_ms_per_call`` takes a profiler window that caught fewer CUDA
    events than calls again, ``WINDOWS`` times in all, then raises: it never
    reports such a window as a device time of 0 (here on the CPU, where no
    call launches a kernel)."""
    from gasfm_tpu_torch.tools import kernel_device_time as kdt

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    with pytest.raises(RuntimeError, match="fewer CUDA events than calls"):
        kdt.device_ms_per_call(lambda: calls.append(1), 4)
    assert len(calls) == 3 + kdt.WINDOWS * 4  # the warm-up, then every window


@pytest.mark.parametrize("dropped", ["one kernel", "some events"])
def test_kernel_device_time_takes_no_window_that_dropped_events(monkeypatch, dropped):
    """A profiler window that kept only some of its kernel events (here the
    first of three: all of one kernel's, or a few of each) still holds at
    least one event per call; ``device_ms_per_call`` takes its time only
    from a window whose events a second window matched, none more."""
    import types

    from gasfm_tpu_torch.tools import kernel_device_time as kdt

    calls, per_call = 4, {"main": 2.0, "merge": 1.0}  # us per launch
    first = ({"main": calls} if dropped == "one kernel" else {"main": calls - 1, "merge": 2})
    windows = iter([first, *[{k: calls for k in per_call}] * 2])

    class Window:
        def __enter__(self):
            self.counts = next(windows)
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [types.SimpleNamespace(device_type=kdt.DeviceType.CUDA, name=f"{k}(args)",
                                          time_range=types.SimpleNamespace(
                                              elapsed_us=lambda k=k: per_call[k]))
                    for k, n in self.counts.items() for _ in range(n)]

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(kdt, "profile", lambda **kw: Window())
    ms, names = kdt.device_ms_per_call(lambda: None, calls)
    assert ms == pytest.approx(3.0 / 1e3)
    assert names == {"main": (1.0, 0.002), "merge": (1.0, 0.001)}
    assert next(windows, None) is None  # the third window was the first to count
