"""Multi-host ``parallel.distributed`` on the CPU: two launcher processes on
one machine, each standing for a host, meet on a TCP store at
``127.0.0.1`` and a free port (loopback only), as one launcher per host
would at the coordinator's address.

Each launcher is an OS process of its own (``tests/torch_port_mesh_ranks.py``
``launcher_main``: ``gasfm_tpu_torch.parallel.run_ranks`` with its
``Distributed``), which spawns its local ranks; they run
tests/torch_port_mesh_ranks.py, which imports no JAX, on the CPU with one
intra-op thread. The reference is one ``run_ranks`` launcher of the same
mesh, which tests/test_torch_port_parallel.py and
tests/test_torch_port_table_sharding.py hold against the JAX package:

- ``[1, 2]`` table-sharded and ``[2, 1]`` (one rank per launcher), and
  ``[2, 2]`` (two local ranks per launcher), the flagship-shaped merged
  GASFM: the first step's loss, gradients and predictions and the later
  steps' values and weight digests bitwise the one launcher's; each
  launcher returns its own ranks, global rank ``process_id x local +
  local rank`` with the one launcher's data slot and edge shard.
- The CLI: ``single-scene-optim`` under ``[1, 2]`` as two ``python -m
  gasfm_tpu_torch.main`` processes, one per ``process_id``, each with a
  results directory of its own and ``--overwrite-exp``: both exit 0,
  process 0 wipes and writes the one tree, process 1 wipes and writes
  nothing.
- A rank that raises on launcher 1: launcher 0 fails with its traceback
  within 60 s, not after the collectives' timeout.
"""

import concurrent.futures
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_mesh_ranks as R
from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.losses import FLAGSHIP_LOSS
from gasfm_tpu_torch.parallel import Distributed, run_ranks

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
MERGED = dict(num_layers=2, n_heads=4, n_feat_proj=32, n_feat_scenepoint=24, n_feat_view=40,
              n_feat_global=48, stateful_global_features=True,
              add_skipconn_from_init_projfeat=True)
STEPS = 3  # the first step, then two
FAIL_WITHIN_S = 60
LAUNCH = ("import sys; sys.path.insert(0, sys.argv[2]); import torch_port_mesh_ranks as R; "
          "sys.exit(R.launcher_main(sys.argv[1]))")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]), OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def scene(seed):
    d = generate_synthetic_scene(n_views=8, n_points=150, visibility=0.5, seed=seed)
    return dict(M=d.M, Ns=d.Ns, y=d.y, depths=None)


def case(n_scenes, table_sharding, mesh=None):
    model = R.MODELS["gasfm"](**MERGED, generator=torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    out = dict(model=("gasfm", MERGED), state=state, loss=("esfm", FLAGSHIP_LOSS),
               optim=dict(lr=1e-3, main_scheduler="constant", grad_clip_mode=None),
               steps=STEPS, fused=True, scenes=[scene(3 + i) for i in range(n_scenes)],
               table_sharding=table_sharding)
    if mesh is not None:
        out["mesh"] = mesh
    return out


def launchers(fn, n_data, n_edge, args, tmp, name):
    """Two launcher processes of ``run_ranks(fn, n_data, n_edge, args)``
    meeting at 127.0.0.1 and a free port: per process id its (status,
    results or error text), and the seconds it took."""
    port = free_port()
    procs = []
    t0 = time.monotonic()
    for pid in range(2):
        path = str(tmp / f"{name}{pid}.pt")
        torch.save((fn, n_data, n_edge, tuple(args), Distributed("127.0.0.1", port, 2, pid)),
                   path)
        procs.append((path, subprocess.Popen([sys.executable, "-c", LAUNCH, path, str(TESTS)],
                                             cwd=ROOT, env=child_env(),
                                             stdout=subprocess.DEVNULL,
                                             stderr=subprocess.DEVNULL)))
    out = []
    for path, p in procs:
        rc = p.wait(timeout=600)
        out.append((rc, torch.load(path + ".out", weights_only=False),
                    time.monotonic() - t0))
    return out


def clis(tmp):
    """``single-scene-optim`` under [1, 2] as two processes meeting at
    127.0.0.1 and a free port, each into a results directory of its own
    that holds a stale tree first: per process id (exit code, stdout,
    stderr)."""
    port = free_port()
    procs = []
    for pid in range(2):
        results = tmp / f"results{pid}"
        (results / "mh").mkdir(parents=True)
        (results / "mh" / "stale.txt").write_text("from an earlier run")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gasfm_tpu_torch.main", "single-scene-optim", "--conf",
             "synth/optim_synth_gasfm.conf", "--device", "cpu", "--exp-dir", "mh",
             "--overwrite-exp", "--external-params", "train.n_epochs=2", "eval.eval_interval=1",
             "parallel.mesh_shape=[1,2]", "parallel.distributed.enabled=true",
             f'parallel.distributed.coordinator_address="127.0.0.1:{port}"',
             "parallel.distributed.num_processes=2", f"parallel.distributed.process_id={pid}"],
            cwd=ROOT, env=child_env(GASFM_RESULTS_PATH=str(results)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        out.append((p.returncode, stdout, stderr))
    return out


class _Runs:
    """The file's spawns, three at a time on threads: one launcher of the
    two-rank cases ([1, 2] table-sharded, [2, 1] as another layout of the
    same ranks) and of the four-rank case ([2, 2]), two launchers of each,
    the CLI's two processes, and the failing pair."""

    def __init__(self, tmp):
        self.cases = {2: [case(1, None), case(2, None, mesh=(2, 1))], 4: [case(2, None)]}
        shapes = {2: (1, 2), 4: (2, 2)}
        pool = concurrent.futures.ThreadPoolExecutor(3)
        self.one = {k: pool.submit(run_ranks, R.multihost_cases, *shapes[k],
                                   args=(self.cases[k],), device="cpu") for k in shapes}
        self.two = {k: pool.submit(launchers, R.multihost_cases, *shapes[k], (self.cases[k],),
                                   tmp, f"mesh{k}_") for k in shapes}
        self.cli = pool.submit(clis, tmp)
        self.failing = pool.submit(launchers, R.raise_on, 1, 2, (1,), tmp, "failing")
        self.tmp, self.pool = tmp, pool


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("multihost"))
    yield r
    r.pool.shutdown()


def two_launchers(runs, world):
    """Both launchers' ranks' results, in global rank order, after checking
    that each launcher returned its own ranks and exited 0."""
    out = runs.two[world].result()
    ranks = []
    for pid, (rc, (status, res), _) in enumerate(out):
        assert rc == 0 and status == "ok", res
        local = world // 2
        assert [lay["rank"] for lay, _ in res] == list(range(pid * local, (pid + 1) * local))
        assert len({lay["launcher"] for lay, _ in res}) == 1
        ranks += res
    assert len({lay["launcher"] for lay, _ in ranks}) == 2
    return ranks


def assert_bitwise(got, want, what):
    assert got["loss"] == want["loss"], what
    assert got["steps"] == want["steps"] and got["digests"] == want["digests"], what
    for part in ("grads", "pred", "state"):
        assert sorted(got[part]) == sorted(want[part])
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=f"{what} {part} {k}")


@pytest.mark.parametrize("world, index, label", [(2, 0, "[1, 2] table-sharded"),
                                                 (2, 1, "[2, 1]"), (4, 0, "[2, 2]")])
def test_two_launchers_bitwise_one_launcher(runs, world, index, label):
    """The first step's loss, gradients and predictions, the later steps'
    values and the weights after every update on two launchers, rank by
    rank, bitwise those of one launcher of the same mesh; the weights equal
    on every rank."""
    two, one = two_launchers(runs, world), runs.one[world].result()
    assert len(two) == len(one) == world
    for (lay2, res2), (lay1, res1) in zip(two, one):
        assert lay2["rank"] == lay1["rank"]
        assert_bitwise(res2[index], res1[index], f"{label} rank {lay2['rank']}")
    assert len({res[index]["digests"][-1] for _, res in two}) == 1


def test_global_rank_layout(runs):
    """[2, 2] on two launchers of two local ranks: launcher 0 runs global
    ranks 0 and 1 (data slot 0, edge shards 0 and 1), launcher 1 ranks 2
    and 3 (data slot 1), the one launcher's layout."""
    two, one = two_launchers(runs, 4), runs.one[4].result()
    want = [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    for ranks in (two, one):
        assert [(lay["rank"], lay["data_slot"], lay["edge_shard"]) for lay, _ in ranks] == want


def test_cli_on_two_launchers_writes_one_tree(runs):
    """``single-scene-optim`` under [1, 2] as two CLI processes: both exit 0;
    process 0 wiped its stale tree and wrote the one tree; process 1 wiped
    nothing, wrote nothing and printed nothing of the run."""
    (rc0, out0, err0), (rc1, out1, err1) = runs.cli.result()
    assert rc0 == 0, err0[-3000:]
    assert rc1 == 0, err1[-3000:]
    exp = runs.tmp / "results0" / "mh"
    assert not (exp / "stale.txt").exists()
    assert (exp / "code").is_dir() and len(os.listdir(exp / "tb")) == 1
    rows = (exp / "final_train_errors_OPTIMIZATION.csv").read_text().splitlines()
    header, row = rows[0].split(","), rows[1].split(",")
    assert np.isfinite(float(row[header.index("our_repro")]))
    assert "#Trainable parameters" in out0
    assert [p.name for p in (runs.tmp / "results1").rglob("*")] == ["mh", "stale.txt"]
    assert "our_repro" not in out1 and "#Trainable" not in out1


def test_failing_rank_ends_the_other_launcher(runs):
    """Rank 1 raises on launcher 1 while rank 0 waits for it in an
    all-reduce on launcher 0: both launchers fail with rank 1's traceback,
    launcher 0 within 60 s."""
    for rc, (status, text), seconds in runs.failing.result():
        assert rc == 1 and status == "error"
        assert "rank 1 (process 1)" in text and "rank 1 fails on purpose" in text, text
        assert seconds < FAIL_WITHIN_S
