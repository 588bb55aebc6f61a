"""Rules of the PyTorch/CUDA port (gasfm_tpu_torch).

- It stands alone: importing every module of the package, and chip_smoke.py
  as a module, loads neither JAX nor any module of the JAX package.
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
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _tiny_model():
    from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet

    return GraphAttnSfMNet(num_layers=1, n_heads=2, n_feat_proj=8, n_feat_scenepoint=8,
                           n_feat_view=8, n_feat_global=8)


@pytest.mark.parametrize("entry", ["session", "graph"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
    from gasfm_tpu_torch.losses import ESFMLoss
    from gasfm_tpu_torch.train.loop import TrainingSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = generate_synthetic_scene(n_views=6, n_points=60, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "session":
            TrainingSession(_tiny_model(), ESFMLoss())
        else:
            data.to_scene_graph()
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
