"""The optimizer's state on the device, the recorded step's bookkeeping,
checkpoints, weight files shared with the JAX package, and the bench, on
the CPU.

- The learning-rate tensor against the JAX package's schedule at each batch
  (one of them a batch without an update), and Adam's step count a tensor
  that counts updates only.
- ``capture=True`` on a CPU session raises. A CUDA graph runs only on the
  card (``chip_smoke.py`` replays it there against the eager step); here a
  stand-in that records by keeping the first recorded outputs and replays
  by writing a fresh run's results into them in place holds the session's
  bookkeeping (the learning rate, the schedule's count, the copies of a
  replay's outputs, ``update`` reading a recorded ``loss_and_grads``'
  gradients) to the eager session's, bitwise.
- ``save_params`` of the port loaded by the JAX package's ``load_params``
  (every key present) into its init, and the JAX forward (packed and merged
  Pallas kernels in interpret mode, as tests/test_torch_port_model.py runs
  them) against the port's at that file's weights, within that file's
  tolerance (rtol 1e-3, atol 1e-4 x scale); and the reverse, a JAX
  ``save_params`` file loaded by the port's ``load_params``.
- The bitwise comparisons run with ``torch.use_deterministic_algorithms``.
- A checkpoint, 2 steps, a restore in place (the same ``data_ptr``s), the
  same 2 steps: bitwise equal parameters, Adam's moments and step count,
  the schedule's count and the step; the newest ``keep`` kept.
- The bench's timing on the CPU, eager, a 2-layer model on a small scene:
  its JSON line's keys; the captured mode on the CPU raises.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.models.gasfm import GraphAttnSfMNet as JaxGraphAttnSfMNet
from gasfm_tpu.ops.segment import set_kernel_mode
from gasfm_tpu.train.schedules import build_lr_schedule as jax_schedule
from gasfm_tpu.train.state import advance_schedule_count
from gasfm_tpu.train.state import build_optimizer as jax_build_optimizer
from gasfm_tpu.train.state import load_params as jax_load_params
from gasfm_tpu.train.state import save_params as jax_save_params

from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.losses import DEPTH_LOSS, FLAGSHIP_LOSS, DirectDepthLoss, ESFMLoss
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.tools import bench
from gasfm_tpu_torch.train import loop
from gasfm_tpu_torch.train.loop import TrainingSession
from gasfm_tpu_torch.train.state import (build_optimizer, load_params, restore_checkpoint,
                                         save_checkpoint, save_params)

from test_torch_port_model import CONFIGS, assert_close
from test_torch_port_train import OPTIM, conf

# tests/test_torch_port_model.py's second configuration: 2 layers, merged.
WIDTHS = CONFIGS["stateless_broadcast"]
SMALL = dict(n_views=8, n_points=600, visibility=0.5, seed=9)
DEPTH = dict(WIDTHS, depth_head_enabled=True, view_head_enabled=False,
             scenepoint_head_enabled=False, depth_head_n_feat=16, depth_head_n_hidden_layers=1)


def session_of(widths, seed=0, loss=None, capture=None):
    model = GraphAttnSfMNet(**widths, generator=torch.Generator().manual_seed(seed))
    return TrainingSession(model, loss or ESFMLoss(**FLAGSHIP_LOSS), device="cpu", optim=OPTIM,
                           capture=capture)


@pytest.fixture
def deterministic():
    """Deterministic CPU kernels (``index_add_`` of the plain path sums in
    an order that changes run to run otherwise), for the bitwise tests."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.fixture(scope="module")
def small_scene():
    return generate_synthetic_scene(**SMALL).to_scene_graph(device="cpu")


def test_lr_tensor_follows_the_jax_schedule():
    """Batches 0, 1, 3, 4 update, batch 2 does not (advance_schedule): the
    rate tensor Adam reads holds the JAX schedule's value of each updating
    batch, and the parameters after the five batches are the JAX chain's."""
    want = jax_schedule(base_lr=OPTIM["lr"], main_scheduler=OPTIM["main_scheduler"],
                        lr_warmup_n_steps=OPTIM["lr_warmup_n_steps"],
                        exp_gamma_after_n_steps=OPTIM["exp_gamma_after_n_steps"],
                        exp_n_steps=OPTIM["exp_n_steps"])
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=5).astype(np.float32)
    grads = rng.normal(size=(5, 5)).astype(np.float32)
    x = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    opt = build_optimizer([x], **OPTIM)
    assert opt.lr.dim() == 0 and opt.lr.dtype == torch.float32
    assert opt.adam.param_groups[0]["lr"] is opt.lr
    tx, _ = jax_build_optimizer(conf())
    params = {"x": jnp.asarray(x0)}
    state = tx.init(params)
    for batch in range(5):
        if batch == 2:
            opt.advance_schedule()
            state = advance_schedule_count(state)
            continue
        opt.step([torch.from_numpy(grads[batch])])
        assert float(opt.lr) == float(want(batch)), batch
        updates, state = tx.update({"x": jnp.asarray(grads[batch])}, state, params)
        params = optax.apply_updates(params, updates)
    assert opt.schedule_count == 5
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(params["x"]), rtol=1e-6)


def test_adam_step_count_is_a_tensor_that_counts_updates():
    x = torch.nn.Parameter(torch.ones(3, dtype=torch.float32))
    opt = build_optimizer([x], **OPTIM)
    g = torch.full((3,), 0.5, dtype=torch.float32)
    opt.step([g])
    opt.advance_schedule()
    opt.step([g])
    opt.step([g])
    step = opt.adam.state[x]["step"]
    assert isinstance(step, torch.Tensor) and step.device == x.device
    assert float(step) == 3 and opt.schedule_count == 4


def test_capture_on_a_cpu_session_raises():
    with pytest.raises(ValueError, match="records CUDA graphs"):
        session_of(WIDTHS, capture=True)
    assert not session_of(WIDTHS).capture
    assert not session_of(WIDTHS, capture=False).capture


class ReplayStandIn:
    """A CUDA graph's stand-in on the CPU, with ``loop._Program``'s
    interface: made at a function's second call on the same operands (its
    first ran eagerly), it runs the function and keeps that run's arguments
    and outputs as the static ones; its first call returns them, later
    calls replay: a fresh run on the recorded arguments, its results written
    into the static outputs in place."""

    def __init__(self, fn, stream, args, keep=None):
        self.fn, self.args, self.calls = fn, args, 0
        self.out = self.graph = fn(*args)

    def __call__(self):
        self.calls += 1
        if self.calls > 1:
            with torch.no_grad():
                for static, fresh in zip(_leaves(self.out), _leaves(self.fn(*self.args))):
                    static.copy_(fresh)
        return self.out


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    return [t for x in out for t in _leaves(x)]


def recorded(session, monkeypatch):
    """``session`` taking the recorded path, with the stand-in for the graph
    and the warm-up run in place of on a capture stream."""
    monkeypatch.setattr(loop, "_Program", ReplayStandIn)
    monkeypatch.setattr(loop, "_eager_on", lambda stream, fn, *args: fn(*args))
    session.capture = True
    return session


def program(session, kind, scene=None):
    """The session's recording of ``kind`` on ``scene`` (None: its own
    update inputs), or None."""
    calls = session._own if scene is None else session._cache.of(scene)
    return calls.programs.get(kind)


def test_recorded_fused_step_keeps_the_eager_bookkeeping(small_scene, monkeypatch,
                                                         deterministic):
    """Four steps recorded (warm-up, recording, two replays) against four
    eager ones from the same weights: bitwise equal outputs and parameters,
    the same schedule's count and Adam step count; a kept step's loss is
    not overwritten by the next replay."""
    eager = session_of(WIDTHS)
    rec = recorded(session_of(WIDTHS), monkeypatch)
    kept = []
    for _ in range(4):
        want = eager.fused_step(small_scene)
        got = rec.fused_step(small_scene)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        kept.append((got[0], float(got[0])))
    assert all(float(t) == v for t, v in kept)
    assert len({id(t) for t, _ in kept}) == 4
    assert [kind for kind, _ in rec.recordings()] == ["fused_step"]
    assert program(rec, "fused_step", small_scene).calls == 3  # after the eager warm-up
    for a, b in zip(rec.params, eager.params):
        assert torch.equal(a, b)
    assert rec.optimizer.schedule_count == eager.optimizer.schedule_count == 4
    assert float(rec.optimizer.adam.state[rec.params[0]]["step"]) == 4


def test_recorded_depth_step_reads_the_recorded_gradients(monkeypatch, deterministic):
    """The depth model's loop, loss_and_grads + update, recorded: equal to
    eager step for step; from the recording on, update reads the recorded
    gradients where they lie (its own program per recording), and gradients
    that are no recording's (the warm-up's) go through the update's other
    program, whose eager warm-up reads them where they lie."""
    scene = generate_synthetic_scene(store_depth_targets=True, **SMALL).to_scene_graph(
        device="cpu")
    eager = session_of(DEPTH, seed=2, loss=DirectDepthLoss(**DEPTH_LOSS))
    rec = recorded(session_of(DEPTH, seed=2, loss=DirectDepthLoss(**DEPTH_LOSS)), monkeypatch)
    for _ in range(4):
        w_loss, _, w_grads = eager.loss_and_grads(scene)
        w_norm = eager.update(w_grads)
        loss, pred, grads = rec.loss_and_grads(scene)
        norm = rec.update(grads)
        assert torch.equal(loss, w_loss) and torch.equal(norm, w_norm)
    for a, b in zip(rec.params, eager.params):
        assert torch.equal(a, b)
    lg = program(rec, "loss_and_grads", scene)
    assert lg.calls == 3  # after the eager warm-up
    # the warm-up's gradients, read where they lie by the update's eager warm-up
    assert "update" in rec._own.warm and program(rec, "update") is None
    assert rec._update_inputs is None  # no input buffers: that update was never recorded
    assert program(rec, "update", scene).calls == 2  # warm-up at step 2, recorded at 3
    assert rec.optimizer.schedule_count == 4


def test_recorded_update_copies_other_gradients(monkeypatch, deterministic):
    """``update`` given gradients that no recording made, three times: the
    eager warm-up, the recording on the session's own input buffers, a
    replay with the gradients copied in; equal to eager updates bitwise."""
    eager = session_of(WIDTHS)
    rec = recorded(session_of(WIDTHS), monkeypatch)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=gen, dtype=p.dtype) for p in eager.params]
        assert torch.equal(rec.update(grads), eager.update(grads))
    for a, b in zip(rec.params, eager.params):
        assert torch.equal(a, b)
    assert program(rec, "update").calls == 2  # after the eager warm-up
    assert rec._update_inputs is not None and rec._update_inputs[0] is not grads[0]


def jax_forward(widths, params, data):
    """The JAX GraphAttnSfMNet's forward with the packed and merged Pallas
    kernels in interpret mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GASFM_PACKED", "1")
    mp.setenv("GASFM_MERGED", "1")
    set_kernel_mode("interpret")
    try:
        scene = jax_build_scene_graph(data.M, data.Ns, data.y)
        pred = JaxGraphAttnSfMNet(**widths).apply(params, scene.graph)
        return {k: np.asarray(v) for k, v in pred.items()}
    finally:
        set_kernel_mode("auto")
        mp.undo()


def assert_forward_close(model, want, data):
    """The port's forward against the JAX one on the real rows (the JAX
    graph pads its cameras and points)."""
    graph = build_scene_graph(data.M, data.Ns, data.y, device="cpu").graph
    with torch.no_grad():
        got = model(graph)
    assert_close(got["Ps_norm"], want["Ps_norm"][:graph.num_cams], "Ps_norm")
    assert_close(got["pts3D"], want["pts3D"][:, :graph.num_pts], "pts3D")


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_weight_files_load_across_packages(tmp_path, capsys, direction):
    """The port's file into the JAX package's init (every key of it there),
    or a JAX file into a port init of another seed; the JAX forward at the
    loaded weights against the port's."""
    data = jax_synthetic_scene(**SMALL)
    template = JaxGraphAttnSfMNet(**WIDTHS).init(
        jax.random.PRNGKey(0), jax_build_scene_graph(data.M, data.Ns, data.y).graph)
    path = str(tmp_path / "weights.npz")
    if direction == "port_to_jax":
        port = GraphAttnSfMNet(**WIDTHS, generator=torch.Generator().manual_seed(5))
        save_params(path, port)
        params = jax_load_params(path, template)
    else:
        jax_save_params(path, template)
        port = load_params(path, GraphAttnSfMNet(**WIDTHS,
                                                 generator=torch.Generator().manual_seed(6)))
        params = template
    assert "missing" not in capsys.readouterr().out
    assert_forward_close(port, jax_forward(WIDTHS, params, data), data)


def test_load_params_keeps_init_of_missing_keys(tmp_path, capsys):
    src = GraphAttnSfMNet(**WIDTHS, generator=torch.Generator().manual_seed(5))
    save_params(str(tmp_path / "w.npz"), src)
    with np.load(tmp_path / "w.npz") as f:
        kept = {k: f[k] for k in f.files if "view_head" not in k}
    np.savez(tmp_path / "partial.npz", **kept)
    dst = GraphAttnSfMNet(**WIDTHS, generator=torch.Generator().manual_seed(6))
    init = {k: v.clone() for k, v in dst.state_dict().items()}
    load_params(str(tmp_path / "partial.npz"), dst)
    assert "keeping init values" in capsys.readouterr().out
    for k, v in dst.state_dict().items():
        assert torch.equal(v, init[k] if k.startswith("view_head") else src.state_dict()[k]), k


def _state(session):
    adam = session.optimizer.adam.state
    return ([p.detach().clone() for p in session.params],
            [{n: t.clone() for n, t in adam[p].items()} for p in session.params],
            session.optimizer.schedule_count)


def _ptrs(session):
    adam = session.optimizer.adam.state
    return [p.data_ptr() for p in session.params] + [
        t.data_ptr() for p in session.params for t in adam[p].values()]


def test_checkpoint_round_trip_in_place(tmp_path, small_scene, deterministic):
    session = session_of(WIDTHS)
    session.fused_step(small_scene)
    session.advance_schedule()
    save_checkpoint(str(tmp_path), session, step=7)
    ptrs = _ptrs(session)
    a = [session.fused_step(small_scene) for _ in range(2)]
    state_a = _state(session)
    assert restore_checkpoint(str(tmp_path), session) == 7
    assert _ptrs(session) == ptrs
    b = [session.fused_step(small_scene) for _ in range(2)]
    state_b = _state(session)
    assert [[float(v) for v in s] for s in a] == [[float(v) for v in s] for s in b]
    assert state_a[2] == state_b[2] == 4
    for x, y in zip(state_a[0], state_b[0]):
        assert torch.equal(x, y)
    for x, y in zip(state_a[1], state_b[1]):
        assert sorted(x) == sorted(y) == ["exp_avg", "exp_avg_sq", "step"]
        assert all(torch.equal(x[n], y[n]) for n in x)
    assert float(state_b[1][0]["step"]) == 3
    # into a session that has taken no step: Adam's state is made from the file
    fresh = session_of(WIDTHS, seed=1)
    assert restore_checkpoint(str(tmp_path), fresh) == 7
    c = [fresh.fused_step(small_scene) for _ in range(2)]
    assert [[float(v) for v in s] for s in c] == [[float(v) for v in s] for s in a]
    # the newest `keep` stay
    for step in (8, 9, 10):
        save_checkpoint(str(tmp_path), session, step=step, keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000008.pt", "step_000000009.pt", "step_000000010.pt"]
    assert restore_checkpoint(str(tmp_path / "none"), session) is None


def test_bench_line_on_the_cpu(small_scene):
    result = bench.measure_path(lambda capture: session_of(WIDTHS, capture=capture), small_scene,
                                modes=("eager",), steps=2, eager_steps=2, rounds=2)
    line = json.loads(json.dumps(bench.result_line(
        {"gasfm-dense": result, "gasfm-powerlaw": result}, "cpu", None)))
    assert line["metric"] == "gasfm_train_edges_per_s" and line["optimizer"] == "adam: f32, fused"
    assert {"value", "powerlaw_edges_per_s", "nvidia_smi", "device", "paths",
            "adam_device_ms_per_update"} <= set(line)
    eager = line["paths"]["gasfm-dense"]["eager"]
    assert {"ms_per_step", "ms_per_step_rounds", "edges_per_s", "launches_per_step",
            "peak_bytes", "loss", "loss_finite"} <= set(eager)
    assert len(eager["ms_per_step_rounds"]) == 2 and eager["loss_finite"]
    assert line["paths"]["gasfm-dense"]["edges"] == small_scene.graph.num_edges
    with pytest.raises(ValueError, match="records CUDA graphs"):
        bench.measure_path(lambda capture: session_of(WIDTHS, capture=capture), small_scene,
                           modes=("captured",), steps=1, eager_steps=1, rounds=1)
    with pytest.raises(ValueError, match="records CUDA graphs"):
        bench.main(["--device", "cpu"])  # the captured mode, by default
